"""Host-side text tokenization for the text conditioning and the CLIP
scorer."""

from cyclediffusion_tpu_torch.text.tokenizer import (  # noqa: F401
    BertWordPieceTokenizer,
    CLIPBPETokenizer,
    HashTokenizer,
)
