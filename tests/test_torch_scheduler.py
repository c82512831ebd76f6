"""The port's scheduler and pipeline helpers against the JAX package's.

Tables are numpy on both sides and must be equal. The step functions take
f32 tensors on both sides; they agree to f32 rounding (rtol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctrlv_tpu import diffusion as jd
from ctrlv_tpu.pipelines import common as jcommon
from ctrlv_tpu_torch import diffusion as td
from ctrlv_tpu_torch.pipelines import common as tcommon

torch.set_num_threads(1)


@pytest.mark.parametrize("steps", [1, 2, 25, 50])
def test_sigma_tables_equal(steps):
    np.testing.assert_array_equal(td.karras_sigmas(steps), jd.karras_sigmas(steps))
    jstate = jd.EulerDiscreteScheduler().set_timesteps(steps)
    tstate = td.EulerDiscreteScheduler().set_timesteps(steps)
    np.testing.assert_array_equal(tstate.sigmas.numpy(), np.asarray(jstate.sigmas))
    np.testing.assert_array_equal(tstate.timesteps.numpy(), np.asarray(jstate.timesteps))
    assert tstate.init_noise_sigma.item() == float(jstate.init_noise_sigma)
    assert tstate.timesteps.shape[0] == jstate.num_steps == steps


@pytest.mark.parametrize("sigma,sigma_next", [(700.0, 300.0), (1.5, 0.9), (0.002, 0.0)])
def test_step_functions_match(sigma, sigma_next):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    out = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    s, sn = np.float32(sigma), np.float32(sigma_next)
    ts, tsn = torch.tensor(s), torch.tensor(sn)
    tx, tout = torch.from_numpy(x), torch.from_numpy(out)

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)

    close(td.euler_step(tout, tx, ts, tsn), jd.euler_step(out, x, jnp.float32(s), jnp.float32(sn)))
    close(td.scale_model_input(tx, ts), jd.scale_model_input(x, jnp.float32(s)))
    for a, b in zip(td.edm_scalings(ts), jd.edm_scalings(jnp.float32(s))):
        close(a, b)


@pytest.mark.parametrize("do_cfg", [True, False])
def test_conditioning_helpers_match(do_cfg):
    cfg_t = tcommon.SamplingConfig(num_frames=5, fps=6, motion_bucket_id=100)
    cfg_j = jcommon.SamplingConfig(num_frames=5, fps=6, motion_bucket_id=100)
    np.testing.assert_array_equal(
        tcommon.get_add_time_ids(cfg_t, 2, do_cfg).numpy(),
        np.asarray(jcommon.get_add_time_ids(cfg_j, 2, do_cfg)),
    )
    minmax = np.asarray([[1.0, 3.0], [0.5, 2.0]], np.float32)
    np.testing.assert_allclose(
        tcommon.guidance_linspace(5, torch.from_numpy(minmax)).numpy(),
        np.asarray(jcommon.guidance_linspace(cfg_j, 2, 5, jnp.asarray(minmax))),
        rtol=1e-6,
    )
    frames = np.linspace(-1.5, 1.5, 60, dtype=np.float32).reshape(1, 5, 2, 2, 3)
    np.testing.assert_array_equal(
        tcommon.postprocess_frames(torch.from_numpy(frames)).numpy(),
        np.asarray(jcommon.postprocess_frames(jnp.asarray(frames))),
    )
