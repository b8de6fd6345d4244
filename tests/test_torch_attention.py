"""The port's attention step (`semi_tts_tpu_torch/models/attention.py`,
kernel K3 via its plain version on the CPU) against
`semi_tts_tpu.models.attention`."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_tts_tpu.models import attention as J
from semi_tts_tpu_torch.bridge import load_jax_params
from semi_tts_tpu_torch.kernels.attention import attention_step_plain
from semi_tts_tpu_torch.models import attention as P

ATOL = 1e-5  # fp32 on both sides; only summation orders differ


def _setup(use_summed_weights=True, loc_aware=True, seed=0):
    B, L, Q, D, A, F, K = 3, 13, 12, 10, 8, 4, 7  # L not a multiple of 32
    params = J.attention_init(jax.random.PRNGKey(seed), Q, D, A, F, K, loc_aware=loc_aware,
                              use_summed_weights=use_summed_weights)
    params = jax.tree_util.tree_map(np.asarray, params)
    attn = P.Attention(Q, D, A, F, K, loc_aware=loc_aware,
                       use_summed_weights=use_summed_weights, generator=torch.Generator())
    load_jax_params(attn, params, {})
    rng = np.random.RandomState(seed)
    C = 2 if use_summed_weights else 1
    query = rng.randn(B, Q).astype(np.float32)
    memory = rng.randn(B, L, D).astype(np.float32)
    hist = np.abs(rng.rand(B, C, L)).astype(np.float32)
    lengths = np.array([L, 5, 9])
    mask = np.arange(L)[None, :] >= lengths[:, None]
    return params, attn, query, memory, hist, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_summed_weights", [True, False])
def test_attention_step_matches_jax(masked, use_summed_weights):
    params, attn, query, memory, hist, mask = _setup(use_summed_weights)
    pm_j = J.process_memory(params, jnp.asarray(memory))
    ctx_j, w_j = J.attention_step(params, jnp.asarray(query), jnp.asarray(memory), pm_j,
                                  jnp.asarray(hist), mask=jnp.asarray(mask) if masked else None)
    with torch.no_grad():
        mem_t = torch.from_numpy(memory)
        pm_t = P.process_memory(attn, mem_t)
        ctx_p, w_p = P.attention_step(attn, torch.from_numpy(query), mem_t, pm_t,
                                      torch.from_numpy(hist),
                                      mask=torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(pm_t.numpy(), np.asarray(pm_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ctx_p.numpy(), np.asarray(ctx_j), rtol=0, atol=ATOL)
    if masked:
        assert np.all(w_p.numpy()[mask] == 0.0)


def test_attention_step_without_location_matches_jax():
    params, attn, query, memory, hist, _ = _setup(loc_aware=False, seed=1)
    pm_j = J.process_memory(params, jnp.asarray(memory))
    ctx_j, w_j = J.attention_step(params, jnp.asarray(query), jnp.asarray(memory), pm_j,
                                  jnp.asarray(hist))
    with torch.no_grad():
        mem_t = torch.from_numpy(memory)
        ctx_p, w_p = P.attention_step(attn, torch.from_numpy(query), mem_t,
                                      P.process_memory(attn, mem_t), torch.from_numpy(hist))
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ctx_p.numpy(), np.asarray(ctx_j), rtol=0, atol=ATOL)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """The K3 wrapper on CPU tensors returns exactly its plain version and
    counts no launch."""
    from semi_tts_tpu_torch.kernels import attention as k3

    _, attn, query, memory, hist, mask = _setup()
    with torch.no_grad():
        mem_t = torch.from_numpy(memory)
        pm = P.process_memory(attn, mem_t)
        pq = query @ attn.query_layer.w.numpy().T
        args = (torch.from_numpy(pq), pm, mem_t, torch.from_numpy(hist), attn.loc_conv.w,
                attn.loc_linear.w, attn.v.w.reshape(-1), torch.from_numpy(mask))
        before = k3.attention_step.launches
        got = k3.attention_step(*args)
        want = attention_step_plain(*args)
    assert k3.attention_step.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
