"""Host-side text tokenization for the text conditioning."""

from cyclediffusion_tpu_torch.text.tokenizer import HashTokenizer  # noqa: F401
