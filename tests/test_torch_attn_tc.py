"""K4's tensor-core route on the CPU: the route choice, and a model of the
tensor-core kernel's numerics against the JAX reference.

``csrc/flash_attn_tc.cu`` runs only on a card (``tests/test_torch_cuda.py``
holds it against K4's plain version there). What a CPU can check is that
its arithmetic stays within the bf16 tolerance the card tests use:
``_tc_model`` below computes what the kernel computes — S on the raw bf16
q and k with f32 sums, masked, an online softmax over 64-key tiles with
the running max m taken on the raw S and p = 2^(S·c − m·c) in f32
(c = Dh^-0.5·log2(e)), P rounded to bf16 before the second product, l
summed from the rounded P — and is held against the reference's Pallas
kernel in interpret mode and against ``attention_ref``, within rtol 2^-7,
atol 3e-2 (a bf16 P can move a rounded output of magnitude >= 4 by one bf16
ulp, 0.031), at chatglm3-6b's head geometry, at Dh = 120 and 256, and at
the packed short-prompt shape of the engine's LM jobs. The card tests
hold the kernel tighter, row by row (``_bf16_excess``): the model meets
that tolerance at the whisper-tiny and qwen3-moe shapes, and a tail tile
dropped or left unmasked at Tk = 1500 does not.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.attn.attn import flash_attention_fwd as j_flash  # noqa: E402
from repro.kernels.attn.ref import attention_ref as j_ref  # noqa: E402

from repro_torch.kernels.attn import attn as PA  # noqa: E402

RTOL, ATOL = 2 ** -7, 3e-2
BK = 64          # keys per KV tile of the tensor-core kernel


@pytest.fixture
def rng():
    """A generator seeded in each test: ``tests/conftest.py``'s ``rng`` is
    shared by the session, so its draws would depend on which tests ran
    before in the same worker."""
    return np.random.default_rng(0)


def _tc_model(q, k, v, *, causal=True):
    """The tensor-core kernel's arithmetic on bf16 (B, T, H, Dh) tensors."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    c = torch.tensor(dh ** -0.5, dtype=torch.float32) \
        * torch.tensor(math.log2(math.e), dtype=torch.float32)
    qh = q.float().reshape(b, tq, hkv, g, dh)
    t = torch.arange(tq)[:, None]
    m = torch.full((b, hkv, g, tq, 1), -1e30)
    l = torch.zeros((b, hkv, g, tq, 1))
    acc = torch.zeros((b, hkv, g, tq, dh))
    for k0 in range(0, tk, BK):
        kb, vb = k[:, k0:k0 + BK].float(), v[:, k0:k0 + BK].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, kb)
        kpos = k0 + torch.arange(kb.shape[1])[None, :]
        if causal:
            s = torch.where(kpos <= t, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c).to(torch.bfloat16).float()
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, dh).to(q.dtype)


def _qkv(rng, b, tq, tk, hq, hkv, dh):
    """Unit-normal bf16 q, k, v as (jax, torch) pairs of the same values."""
    out = []
    for shape in ((b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh)):
        j = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                        jnp.bfloat16)
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                    .to(torch.bfloat16)))
    return out


def _bf16_excess(out, ref):
    """The card tests' bf16 tolerance (``tests/test_torch_cuda.py``): each
    element within 2^-7 |ref| + 2^-6 rms(ref's row over Dh) of ``ref``, the
    plain version in float32. Returns the largest share of it."""
    ref = ref.float()
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    return ((out.float() - ref).abs()
            / (2 ** -7 * ref.abs() + 2 ** -6 * rms)).max().item()


def _normals(rng, b, tq, tk, hq, hkv, dh):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16)
            for s in ((b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh))]


def _close(got, want):
    got = got.float().numpy()
    want = want.float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.allclose(got, want, rtol=RTOL, atol=ATOL), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 128, "tensor_cores"), (torch.bfloat16, 120,
                                            "tensor_cores"),
    (torch.bfloat16, 256, "tensor_cores"), (torch.bfloat16, 64,
                                            "tensor_cores"),
    (torch.bfloat16, 8, "tensor_cores"), (torch.bfloat16, 12, "cuda_cores"),
    (torch.bfloat16, 100, "cuda_cores"), (torch.float32, 128, "cuda_cores"),
    (torch.float32, 64, "cuda_cores")])
def test_route_choice(dtype, dh, want):
    """bf16 with Dh % 8 == 0 goes to the tensor cores; float32 (held to the
    reference's f32 arithmetic) and other bf16 widths to the CUDA cores."""
    assert PA.route(dtype, dh) == want


@pytest.mark.parametrize("dh,width", [(8, 64), (16, 64), (64, 64),
                                      (72, 128), (120, 128), (128, 128),
                                      (136, 256), (256, 256)])
def test_tc_head_width_pads_to_whole_tma_boxes(dh, width):
    assert PA.tc_head_width(dh) == width


@pytest.mark.parametrize("dh", [0, 12, 100, 264])
def test_tc_head_width_refuses_other_widths(dh):
    with pytest.raises(ValueError):
        PA.tc_head_width(dh)


def test_launch_refuses_before_touching_the_card():
    """``launch`` checks the kernel name and the route before any CUDA
    call, so these raise on a host without a card too."""
    q = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError, match="not a tensor-core input"):
        PA.launch("tensor_cores", q, q, q)
    with pytest.raises(ValueError, match="not a tensor-core input"):
        h = torch.zeros(1, 2, 2, 12, dtype=torch.bfloat16)
        PA.launch("tensor_cores", h, h, h)
    with pytest.raises(ValueError, match="unknown K4 kernel"):
        PA.launch("tensor", q, q, q)


def test_launch_count_spans_both_kernels():
    """``FLASH_KERNEL.launches`` is the sum over the two kernels, and
    setting it to 0 zeroes both (as the smoke test does before a path)."""
    core, tc = PA.FLASH_CORE_KERNEL, PA.FLASH_TC_KERNEL
    saved = core.launches, tc.launches
    try:
        core.launches, tc.launches = 3, 4
        assert PA.FLASH_KERNEL.launches == 7
        PA.FLASH_KERNEL.launches = 0
        assert (core.launches, tc.launches) == (0, 0)
        with pytest.raises(ValueError):
            PA.FLASH_KERNEL.launches = 5
    finally:
        core.launches, tc.launches = saved


@pytest.mark.parametrize("b,t,hq,hkv,dh,blocks", [
    (1, 80, 32, 2, 128, (16, 16)),      # chatglm3-6b's heads, two KV tiles
    (2, 16, 32, 2, 128, (16, 16)),      # the engine's LM job, packed
    (2, 77, 32, 8, 120, (16, 16)),      # Dh padded to 128
    (1, 70, 16, 8, 256, (16, 32)),      # one consumer warpgroup
    (2, 5, 8, 1, 64, (8, 8))])          # packed rows past a head's end
def test_tc_model_matches_pallas_interpret_and_oracle(b, t, hq, hkv, dh,
                                                      blocks, rng):
    (jq, q), (jk, k), (jv, v) = _qkv(rng, b, t, t, hq, hkv, dh)
    got = _tc_model(q, k, v)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    _close(got, j_flash(jq, jk, jv, block_q=blocks[0], block_k=blocks[1]))
    _close(got, j_ref(jq, jk, jv))
    # and against K4's plain version, which the card tests hold it to
    _close(got, PA.flash_attention_fwd(q, k, v))


@pytest.mark.parametrize("tq,tk,dh", [(16, 133, 128), (40, 17, 64)])
def test_tc_model_noncausal(tq, tk, dh, rng):
    (jq, q), (jk, k), (jv, v) = _qkv(rng, 2, tq, tk, 8, 2, dh)
    got = _tc_model(q, k, v, causal=False)
    _close(got, j_flash(jq, jk, jv, causal=False, block_q=8, block_k=8))
    _close(got, j_ref(jq, jk, jv, causal=False))
    _close(got, PA.flash_attention_fwd(q, k, v, causal=False))


def test_tc_model_tolerance_is_needed_and_enough(rng):
    """At outputs of magnitude >= 4 the bf16 P moves the rounded output by
    up to one bf16 ulp (0.031): the model stays within the stated tolerance
    of the reference, and a tolerance of half an ulp would not hold."""
    b, t, hq, hkv, dh = 1, 64, 4, 1, 64
    (jq, q), (jk, k), (jv, v) = _qkv(rng, b, t, t, hq, hkv, dh)
    v = (v.float() * 6).to(torch.bfloat16)
    jv = jnp.asarray(v.float().numpy(), jnp.bfloat16)
    got = _tc_model(q, k, v).float().numpy()
    want = np.asarray(j_ref(jq, jk, jv), np.float32)
    assert np.allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(got - want).max() > 0.5 * 2 ** -7 * 4


@pytest.mark.parametrize("b,tq,tk,hq,hkv,dh,causal", [
    (2, 1500, 1500, 6, 6, 64, False),   # the whisper-tiny encoder
    (2, 448, 1500, 6, 6, 64, False),    # its cross-attention
    (2, 448, 448, 6, 6, 64, True),      # its decoder
    (1, 2048, 2048, 16, 1, 128, True),  # one of qwen3-moe's KV heads
    (8, 16, 16, 32, 2, 128, True)])     # the engine's chatglm3 LM job
def test_tc_model_within_the_card_tolerance(b, tq, tk, hq, hkv, dh, causal,
                                            rng):
    """The kernel's arithmetic stays within half the card tests' row-scaled
    bf16 tolerance of the plain version in float32 (its bf16 P moves a row
    by a few thousandths of the row's rms)."""
    q, k, v = _normals(rng, b, tq, tk, hq, hkv, dh)
    want = PA.flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                      causal=causal)
    assert _bf16_excess(_tc_model(q, k, v, causal=causal), want) <= 0.75


def test_card_tolerance_catches_a_lost_or_unmasked_tail(rng):
    """At Tk = 1500 (a 28-key tail in 64-key tiles) an output averages
    ~550 values of v, so |out| ~0.04: the kernel with its tail tile
    dropped, or with the tail left unmasked (K and V zero-filled to a whole
    tile), fails the row-scaled tolerance. The unmasked tail passes the
    flat rtol 2^-7, atol 3e-2, which is as large as the outputs."""
    q, k, v = _normals(rng, 2, 1500, 1500, 6, 6, 64)
    want = PA.flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                      causal=False)
    dropped = _tc_model(q, k[:, :1472], v[:, :1472], causal=False)
    zeros = torch.zeros(2, 36, 6, 64, dtype=torch.bfloat16)
    unmasked = _tc_model(q, torch.cat([k, zeros], 1),
                         torch.cat([v, zeros], 1), causal=False)
    assert _bf16_excess(dropped, want) > 10
    assert _bf16_excess(unmasked, want) > 1.2
    assert torch.allclose(unmasked.float(), want, rtol=RTOL, atol=ATOL)
