"""K4′, the gradient of K4 (``repro_torch.kernels.attn.attn``), on the CPU:
its plain version ``flash_attention_bwd_ref`` against torch's autograd of
K4's plain forward and against ``jax.vjp`` of the reference's training
attention (``repro.models.attention.flash_attention``, the chunked jnp
softmax whose gradient is its recompute VJP), ``torch.autograd.gradcheck``
of ``FlashAttention`` in float64, and the Function's host route.

Inputs are numpy draws from a generator seeded in each test. Tolerances:
float32 against autograd and against the reference within 2e-5 of the
gradient's largest magnitude (sums of products in another order: the
reference streams the softmax over chunks, the plain version does not);
gradcheck at its float64 defaults. The CUDA kernel itself is held against
the plain version by ``tests/test_torch_cuda.py`` (card only).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402

from repro_torch.kernels.attn import attn as PA  # noqa: E402

TOL = 2e-5
# (B, Tq, Tk, Hq, Hkv, Dh, causal): causal and not, Tq != Tk, G = 1, 2, 4,
# Dh 16 and 64, lengths not a multiple of the reference's 16-row chunks
CASES = [(2, 37, 37, 4, 2, 16, True), (1, 37, 37, 4, 4, 16, False),
         (2, 21, 50, 8, 2, 16, False), (1, 40, 40, 4, 1, 64, True),
         (2, 17, 17, 2, 2, 64, True), (1, 9, 33, 4, 1, 64, False)]


def _draw(seed, b, tq, tk, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh),
             (b, tq, hq, dh))]


def _close(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1.0), err


@pytest.mark.parametrize("b,tq,tk,hq,hkv,dh,causal", CASES)
def test_plain_backward_matches_autograd_of_plain_forward(b, tq, tk, hq, hkv,
                                                          dh, causal):
    q, k, v, do = (torch.from_numpy(x) for x in
                   _draw(1, b, tq, tk, hq, hkv, dh))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = PA.flash_attention_fwd_ref(*ins, causal=causal)
    want = torch.autograd.grad(out, ins, do)
    got = PA.flash_attention_bwd_ref(q, k, v, out.detach(), do,
                                     causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w.numpy())


@pytest.mark.parametrize("b,tq,tk,hq,hkv,dh,causal", CASES)
def test_plain_backward_matches_reference_vjp(b, tq, tk, hq, hkv, dh,
                                              causal):
    """The reference's training attention at 16-row chunks (so the draws'
    lengths leave a ragged last chunk), differentiated by ``jax.vjp``."""
    q, k, v, do = _draw(2, b, tq, tk, hq, hkv, dh)
    out, vjp = jax.vjp(
        lambda q, k, v: JA.flash_attention(q, k, v, causal=causal,
                                           window=None, chunk_q=16,
                                           chunk_k=16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    got = PA.flash_attention_bwd_ref(tq_, tk_, tv_,
                                     torch.from_numpy(np.array(out)), tdo,
                                     causal=causal)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal,tk", [(True, 6), (False, 6), (False, 9)])
def test_function_gradcheck_in_float64(causal, tk):
    """``FlashAttention`` on float64 CPU tensors: the plain forward and the
    plain backward, both in float64 there, against finite differences."""
    rng = np.random.default_rng(3)
    tq = 6 if causal else 5
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((1, tq, 4, 8), (1, tk, 2, 8), (1, tk, 2, 8)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: PA.FlashAttention.apply(q, k, v, causal), (q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_function_host_route(dtype, causal):
    """``flash_attention_fwd`` on CPU tensors that require grad: the
    forward is the plain version, and the gradients are
    ``flash_attention_bwd``'s (the plain backward cast to the inputs'
    type) bit for bit; no kernel launches."""
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in
                   _draw(4, 2, 13, 13, 4, 2, 16))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (PA.FLASH_KERNEL.launches, PA.FLASH_BWD_KERNEL.launches)
    out = PA.flash_attention_fwd(*ins, causal=causal)
    assert torch.equal(out, PA.flash_attention_fwd_ref(q, k, v,
                                                       causal=causal))
    out.backward(do)
    want = PA.flash_attention_bwd(q, k, v, out.detach(), do, causal=causal)
    for t, w in zip(ins, want):
        assert t.grad.dtype == dtype
        assert torch.equal(t.grad, w)
    assert (PA.FLASH_KERNEL.launches, PA.FLASH_BWD_KERNEL.launches) == before


def test_bwd_checks_its_inputs():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="must be like q"):
        PA.flash_attention_bwd(q, q, q, q[:, :3], q)
    with pytest.raises(ValueError, match="must be like q"):
        PA.flash_attention_bwd(q, q, q, q, q.bfloat16())
