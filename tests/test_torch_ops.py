"""The port's schedule, step math and CFG against the JAX package's, at fp32
on the same numpy inputs.  Tolerance: 1e-6 relative — both sides compute
the same fp32 expressions in the same order; the schedule tables are built
by the same float64 NumPy code and must agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.ops import cfg as jcfg
from cyclediffusion_tpu.ops import schedule as jsched
from cyclediffusion_tpu.ops import steps as jsteps
from cyclediffusion_tpu_torch.ops import cfg, schedule, steps
from test_torch_common import to_torch


@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedules_equal(kind):
    np.testing.assert_array_equal(schedule.make_beta_schedule(kind, 1000),
                                  jsched.make_beta_schedule(kind, 1000))


@pytest.mark.parametrize("steps_,eta", [(50, 0.1), (7, 1.0), (10, 0.0)])
def test_ddim_schedule_tables_equal(steps_, eta):
    betas = schedule.make_beta_schedule("linear", 1000, 0.00085, 0.012)
    got = schedule.DDIMSchedule.create(betas, steps_, eta)
    want = jsched.DDIMSchedule.create(betas, steps_, eta)
    # the load-bearing +1 offset: the grid starts at timestep 1
    assert int(got.timesteps[0]) == 1
    for field in ("timesteps", "alphas", "alphas_prev", "sigmas",
                  "sqrt_one_minus_alphas", "alphas_cumprod", "betas"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert got.alphas.dtype == torch.float32 and got.num_steps == steps_


def _arrays(n, shape=(2, 4, 4, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _coefs():
    sched = jsched.DDIMSchedule.create(
        jsched.make_beta_schedule("linear", 1000, 0.00085, 0.012), 10, 0.3)
    i = 6
    return [np.float32(np.asarray(getattr(sched, f))[i])
            for f in ("alphas", "alphas_prev", "sigmas", "sqrt_one_minus_alphas")]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_step_math_matches():
    a_t, a_prev, sigma, s1ma = _coefs()
    x, e, noise, x0 = _arrays(4)
    T = [torch.tensor(c) for c in (a_t, a_prev, sigma, s1ma)]
    J = [jnp.asarray(c) for c in (a_t, a_prev, sigma, s1ma)]
    tx, te, tn, t0 = (to_torch(a) for a in (x, e, noise, x0))
    jx, je, jn, j0 = (jnp.asarray(a) for a in (x, e, noise, x0))
    _close(steps.q_sample(t0, T[0], tn), jsteps.q_sample(j0, J[0], jn))
    _close(steps.pred_x0_from_eps(tx, te, T[0], T[3]),
           jsteps.pred_x0_from_eps(jx, je, J[0], J[3]))
    for got, want in zip(steps.ddim_step(tx, te, *T, tn, 0.9),
                         jsteps.ddim_step(jx, je, *J, jn, 0.9)):
        _close(got, want)
    _close(steps.compute_eps(tx, tn, te, *T, 0.9),
           jsteps.compute_eps(jx, jn, je, *J, 0.9))
    for zero in (False, True):
        _close(steps.sample_xt_next(t0, tx, *T[:3], tn, zero),
               jsteps.sample_xt_next(j0, jx, *J[:3], jn, zero))


def test_bcast_per_batch_coefficients():
    coef = np.array([0.3, 0.7], np.float32)
    (x, noise) = _arrays(2)
    _close(steps.q_sample(to_torch(x), torch.from_numpy(coef), to_torch(noise)),
           jsteps.q_sample(jnp.asarray(x), jnp.asarray(coef), jnp.asarray(noise)))
    assert steps.bcast(torch.from_numpy(coef), 4).shape == (2, 1, 1, 1)


def test_compute_eps_inverts_ddim_step():
    """compute_eps recovers the noise that ddim_step consumed."""
    a_t, a_prev, sigma, s1ma = (torch.tensor(c) for c in _coefs())
    x, e, noise = (to_torch(a) for a in _arrays(3, seed=1))
    x_prev, _ = steps.ddim_step(x, e, a_t, a_prev, sigma, s1ma, noise)
    rec = steps.compute_eps(x, x_prev, e, a_t, a_prev, sigma, s1ma)
    torch.testing.assert_close(rec, noise, rtol=1e-4, atol=1e-4)


def _model(x, t, c):
    return x * c + 0.01 * t.reshape(-1, 1, 1, 1)


def _jmodel(x, t, c):
    return x * c + 0.01 * t.reshape(-1, 1, 1, 1)


@pytest.mark.parametrize("scale", [0.0, 1.0, 5.0, "tensor"])
def test_cfg_matches(scale):
    x, uc, c = _arrays(3, seed=2)
    t = np.array([3, 9], np.int32)
    if scale == "tensor":
        s_np = np.array([1.0, 5.0], np.float32).reshape(2, 1, 1, 1)
        ts, js = torch.from_numpy(s_np), jnp.asarray(s_np)
    else:
        ts = js = scale
    got = cfg.cfg_model_fn(_model, to_torch(uc), to_torch(c), ts)(
        to_torch(x), torch.from_numpy(t.astype(np.int64)))
    want = jcfg.cfg_model_fn(_jmodel, jnp.asarray(uc), jnp.asarray(c), js)(
        jnp.asarray(x), jnp.asarray(t))
    _close(got, want)


def test_cfg_static_branches_run_single_batch():
    seen = []

    def model(x, t, c):
        seen.append(x.shape[0])
        return x

    x = torch.zeros(2, 1, 1, 1)
    t = torch.zeros(2, dtype=torch.int64)
    for scale in (0.0, 1.0):
        cfg.cfg_model_fn(model, x, x, scale)(x, t)
    cfg.cfg_model_fn(model, x, x, torch.ones(2, 1, 1, 1))(x, t)
    assert seen == [2, 2, 4]
