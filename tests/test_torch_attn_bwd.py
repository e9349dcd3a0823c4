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


def _ref_scores(q, k, causal):
    """The reference's scaled, masked scores in jnp: (B, Hkv, G, Tq, Tk),
    query head h on KV head h // G, NEG where masked."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qh = (jnp.asarray(q) * dh ** -0.5).reshape(b, tq, hkv, hq // hkv, dh)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", qh, jnp.asarray(k))
    if causal:
        s = jnp.where(jnp.arange(tk)[None, :] <= jnp.arange(tq)[:, None], s,
                      JA.NEG)
    return s


@pytest.mark.parametrize("b,tq,tk,hq,hkv,dh,causal", CASES)
def test_plain_lse_matches_reference_logsumexp(b, tq, tk, hq, hkv, dh,
                                               causal):
    """``flash_attention_fwd_ref(..., with_lse=True)``'s LSE, float32
    (B, Hq, Tq), against ``jax.nn.logsumexp`` of the reference's scaled,
    masked scores on the same numpy inputs: the m + log l that the
    reference's Pallas K4 keeps beside its accumulator. The output is the
    plain version's without the LSE, bit for bit."""
    q, k, v, _ = _draw(5, b, tq, tk, hq, hkv, dh)
    want = jax.nn.logsumexp(_ref_scores(q, k, causal), axis=-1)
    tq_, tk_, tv_ = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = PA.flash_attention_fwd_ref(tq_, tk_, tv_, causal=causal,
                                          with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, tq)
    _close(lse, np.asarray(want).reshape(b, hq, tq))
    assert torch.equal(out, PA.flash_attention_fwd_ref(tq_, tk_, tv_,
                                                       causal=causal))


@pytest.mark.parametrize("b,tq,tk,hq,hkv,dh,causal", CASES)
def test_plain_backward_unchanged_given_the_lse(b, tq, tk, hq, hkv, dh,
                                                causal):
    """``flash_attention_bwd_ref`` given the forward's LSE (P = exp(S −
    lse)) computes the gradient it computes from its own softmax."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _draw(6, b, tq, tk, hq, hkv, dh))
    out, lse = PA.flash_attention_fwd_ref(q, k, v, causal=causal,
                                          with_lse=True)
    want = PA.flash_attention_bwd_ref(q, k, v, out, do, causal=causal)
    got = PA.flash_attention_bwd_ref(q, k, v, out, do, causal=causal, lse=lse)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w.numpy())
    # the wrapper's host route takes it too
    got = PA.flash_attention_bwd(q, k, v, out, do, causal=causal, lse=lse)
    for g, w in zip(got, want):
        _close(g, w.numpy())


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 128, "tensor_cores"), (torch.bfloat16, 64, "tensor_cores"),
    (torch.bfloat16, 120, "tensor_cores"), (torch.bfloat16, 8, "tensor_cores"),
    (torch.bfloat16, 136, "cuda_cores"), (torch.bfloat16, 256, "cuda_cores"),
    (torch.bfloat16, 12, "cuda_cores"), (torch.bfloat16, 320, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 128, "cuda_cores")])
def test_bwd_route_choice(dtype, dh, want):
    """K4′ takes the tensor cores for bf16 with Dh % 8 == 0 and Dh <= 128
    (dK and dV accumulators of a 256-wide head would not fit a thread's
    registers); everything else stays on the CUDA cores."""
    assert PA.bwd_route(dtype, dh) == want
    assert PA.BWD_PASSES[want] == {"tensor_cores": 3, "cuda_cores": 4}[want]


@pytest.mark.parametrize("g,want", [(1, 1), (2, 2), (4, 4), (5, 1), (6, 3),
                                    (8, 4), (16, 4)])
def test_bwd_groups(g, want):
    """The dK/dV pass's query-head groups: the largest divisor of G that
    is at most 4 (chatglm3-6b's G = 16: 4 groups of 4)."""
    assert PA.bwd_groups(g) == want and g % want == 0


def test_tc_route_refuses_a_call_without_lse():
    """The tensor-core K4′ needs the forward's LSE: ``flash_attention_bwd``
    raises without it, on its argument checks, before any CUDA call (so
    this runs on ``meta`` tensors, with no card). With the LSE the same
    call gets as far as the device check. The other argument checks come
    first too."""
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    q, k, o = meta(1, 64, 8, 128), meta(1, 64, 2, 128), meta(1, 64, 8, 128)
    lse = meta(1, 8, 64, dtype=torch.float32)
    assert PA.bwd_route(q.dtype, 128) == "tensor_cores"
    with pytest.raises(ValueError, match="needs the forward's log-sum-exp"):
        PA.flash_attention_bwd(q, k, k, o, o)
    with pytest.raises(ValueError, match="needs the forward's log-sum-exp"):
        PA.bwd_launch("tensor_cores", q, k, k, o, o)
    with pytest.raises(ValueError, match="unsupported device"):
        PA.flash_attention_bwd(q, k, k, o, o, lse=lse)
    with pytest.raises(ValueError, match="must be torch.float32"):
        PA.flash_attention_bwd(q, k, k, o, o, lse=lse[:, :, :5])
    with pytest.raises(ValueError, match="not a tensor-core input"):
        f = meta(1, 64, 8, 128, dtype=torch.float32)
        PA.bwd_launch("tensor_cores", f, f[:, :, :2], f[:, :, :2], f, f,
                      lse=lse)
    with pytest.raises(ValueError, match="unknown K4′ kernel"):
        PA.bwd_launch("tensor", q, k, k, o, o, lse=lse)
    # the CUDA-core route takes a call without the LSE
    with pytest.raises(ValueError, match="unsupported device"):
        PA.bwd_launch("cuda_cores", q, k, k, o, o)


def test_bwd_launch_count_spans_both_routes():
    """``FLASH_BWD_KERNEL.launches`` is the sum over K4′'s two kernels,
    and setting it to 0 zeroes both."""
    core, tc = PA.FLASH_BWD_CORE_KERNEL, PA.FLASH_BWD_TC_KERNEL
    saved = core.launches, tc.launches
    try:
        core.launches, tc.launches = 8, 12
        assert PA.FLASH_BWD_KERNEL.launches == 20
        PA.FLASH_BWD_KERNEL.launches = 0
        assert (core.launches, tc.launches) == (0, 0)
        with pytest.raises(ValueError):
            PA.FLASH_BWD_KERNEL.launches = 3
    finally:
        core.launches, tc.launches = saved


# K4′'s tolerances on the card (chip_smoke.py's K4B_TC_TOL and
# K4B_BF16_TOL): a |ref| + b rms(ref's row) + c rms(ref)
_TC_TOL = (2 ** -7, 2 ** -6, 2 ** -14)
_CORE_BF16_TOL = (2 ** -7, 2 ** -10, 2 ** -16)


def _excess(got, want, tol):
    a, b, c = tol
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    return ((got.float() - want).abs()
            / (a * want.abs() + b * rms + c * want.pow(2).mean().sqrt())).max()


def _tc_bwd_model(q, k, v, out, dout, causal):
    """The tensor-core K4′'s numerics on the host, in float32 from bf16
    inputs: K4's LSE (m + log l, l the sum of the bf16-rounded P as K4's
    kernel sums it), P = exp(S·c − lse), D from the bf16 output, and P
    (for dV) and dS (for dK and dQ) rounded to bf16 before their
    products; outputs rounded to bf16."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g, c = hq // hkv, dh ** -0.5
    bf = (lambda t: t.bfloat16().float())
    qf = q.float().reshape(b, tq, hkv, g, dh)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * c
    if causal:
        s = torch.where(torch.arange(tk)[None, :] <= torch.arange(tq)[:, None],
                        s, torch.tensor(PA.NEG))
    m = s.amax(-1, keepdim=True)
    lse = m + torch.log(bf(torch.exp(s - m)).sum(-1, keepdim=True))
    p = torch.exp(s - lse)
    do = dout.float().reshape(b, tq, hkv, g, dh)
    d = (do * out.float().reshape(b, tq, hkv, g, dh)).sum(-1)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", do, vf)
              - d.permute(0, 2, 3, 1)[..., None])
    dq = c * torch.einsum("bhgqk,bkhd->bqhgd", bf(ds), kf)
    dk = c * torch.einsum("bhgqk,bqhgd->bkhd", bf(ds), qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", bf(p), do)
    return tuple(t.bfloat16() for t in (dq.reshape(b, tq, hq, dh), dk, dv))


@pytest.mark.parametrize("b,tq,tk,hq,hkv,dh,causal", [
    (1, 256, 256, 8, 1, 128, True), (1, 300, 300, 2, 2, 64, False),
    (1, 64, 300, 2, 2, 64, False)])
def test_tc_bwd_model_within_its_tolerance(b, tq, tk, hq, hkv, dh, causal):
    """A host model of the tensor-core K4′'s rounding (``_tc_bwd_model``)
    stays within the tensor-core tolerance of the plain version, which the
    card holds the kernel to; and it exceeds the CUDA-core route's bf16
    tolerance, whose row term (2^-10) leaves no room for a bf16 P and dS:
    the tensor-core route needs its wider 2^-6."""
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).bfloat16() for s in ((b, tq, hq, dh), (b, tk, hkv, dh),
                                          (b, tk, hkv, dh), (b, tq, hq, dh)))
    out = PA.flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                     causal=causal).bfloat16()
    ref = PA.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                     out.float(), do.float(), causal=causal)
    got = _tc_bwd_model(q, k, v, out, do, causal)
    assert max(_excess(g, r, _TC_TOL) for g, r in zip(got, ref)) <= 1.0
    assert max(_excess(g, r, _CORE_BF16_TOL) for g, r in zip(got, ref)) > 1.0
