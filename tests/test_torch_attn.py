"""K4's plain version and the port's attention against the JAX reference, on
the CPU.

``repro_torch.kernels.attn.attn.flash_attention_fwd`` on a CPU tensor is
K4's plain version (the CUDA kernel has no host mode; ``tests/
test_torch_cuda.py`` holds the kernel against it on a card). It is held
against the reference's Pallas kernel in interpret mode and its oracle
``attention_ref``; the port's ``models.attention.flash_attention`` against
the reference's chunked jnp version, with and without a window; the
encoder's ``attn_train`` (causal or not) and the decoder's
``cross_attn_train`` against the reference's, with the K4 calls they
make recorded. Inputs are
unit normals from a seeded numpy generator. Tolerances: 2e-5 in float32
(sums in another order), 3e-2 in bfloat16 (one bf16 rounding of outputs
of order 1), the reference's own in ``tests/test_kernels_attn.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.attn.attn import flash_attention_fwd as j_flash  # noqa: E402
from repro.kernels.attn.ref import attention_ref as j_ref  # noqa: E402
from repro.models.attention import flash_attention as j_chunked  # noqa: E402

from repro_torch.kernels.attn import attn as PA  # noqa: E402
from repro_torch.kernels.attn.ops import flash_attention_fwd  # noqa: E402
from repro_torch.models import attention as MA  # noqa: E402

_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(rng, b, tq, tk, hq, hkv, dh, dtype):
    """Unit-normal q, k, v as (jax, torch) pairs of the same values (bf16
    values are rounded once, by JAX, and carried bit for bit)."""
    jdt, tdt = _DT[dtype]
    out = []
    for shape in ((b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh)):
        j = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jdt)
        t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
        out.append((j, t))
    return out


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=tol, rtol=0), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("tq,hq,hkv,dh", [(33, 4, 2, 16), (64, 4, 1, 32),
                                          (40, 6, 6, 8), (17, 8, 2, 16)])
@pytest.mark.parametrize("blocks", [(16, 8), (32, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_and_oracle(tq, hq, hkv, dh, blocks,
                                                   dtype, rng):
    (jq, q), (jk, k), (jv, v) = _qkv(rng, 2, tq, tq, hq, hkv, dh, dtype)
    before = PA.FLASH_KERNEL.launches
    got = flash_attention_fwd(q, k, v)
    assert got.dtype == q.dtype and PA.FLASH_KERNEL.launches == before
    _close(got, j_flash(jq, jk, jv, block_q=blocks[0], block_k=blocks[1]),
           _TOL[dtype])
    _close(got, j_ref(jq, jk, jv), _TOL[dtype])


@pytest.mark.parametrize("tq,tk", [(24, 24), (24, 40), (40, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_noncausal(tq, tk, dtype, rng):
    (jq, q), (jk, k), (jv, v) = _qkv(rng, 1, tq, tk, 4, 2, 8, dtype)
    got = flash_attention_fwd(q, k, v, causal=False)
    _close(got, j_flash(jq, jk, jv, causal=False, block_q=8, block_k=8),
           _TOL[dtype])
    _close(got, j_ref(jq, jk, jv, causal=False), _TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_at_chatglm3_head_geometry(dtype, rng):
    """chatglm3-6b's heads (32 query over 2 KV heads, Dh = 128) at T = 33."""
    (jq, q), (jk, k), (jv, v) = _qkv(rng, 1, 33, 33, 32, 2, 128, dtype)
    got = flash_attention_fwd(q, k, v)
    _close(got, j_flash(jq, jk, jv, block_q=16, block_k=16), _TOL[dtype])
    _close(got, j_ref(jq, jk, jv), _TOL[dtype])


@pytest.mark.parametrize("t,window,chunk", [(48, None, 16), (37, None, 16),
                                            (37, 16, 16), (50, 8, 16),
                                            (20, 64, 8)])
def test_model_flash_attention_matches_reference(t, window, chunk, rng):
    """The port's ``flash_attention`` (K4's route with no window, the banded
    plain path with one) against the reference's chunked jnp version."""
    (jq, q), (jk, k), (jv, v) = _qkv(rng, 2, t, t, 4, 2, 16, "float32")
    got = MA.flash_attention(q, k, v, causal=True, window=window,
                             chunk_q=chunk, chunk_k=chunk)
    want = j_chunked(jq, jk, jv, causal=True, window=window, chunk_q=chunk,
                     chunk_k=chunk)
    _close(got, want, _TOL["float32"])


def test_full_attention_with_offset_waits_for_decode(rng, monkeypatch):
    """Full attention with ``q_offset != 0`` against the reference's: the
    chunked streaming softmax in plain PyTorch, never K4, which has no
    offset. The name is kept from before decode was ported, when the
    offset raised and this test held that it did."""
    (jq, q), (jk, k), (jv, v) = _qkv(rng, 1, 4, 7, 2, 2, 8, "float32")
    calls = _k4_calls(monkeypatch)
    got = MA.flash_attention(q, k, v, causal=True, window=None, chunk_q=4,
                             chunk_k=4, q_offset=3)
    want = j_chunked(jq, jk, jv, causal=True, window=None, chunk_q=4,
                     chunk_k=4, q_offset=3)
    _close(got, want, _TOL["float32"])
    assert calls == []


@pytest.mark.parametrize("bad", ["gqa", "dh", "dtype", "shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k = torch.zeros(1, 4, 6, 8), torch.zeros(1, 4, 4, 8)
    if bad == "gqa":
        args, err = (q, k, k), ValueError
    elif bad == "dh":
        # the plain version takes any width; the kernels stop at Dh 512
        wide = torch.zeros(1, 4, 2, 520)
        with pytest.raises(ValueError, match="520"):
            PA.launch("cuda_cores", wide, wide, wide)
        empty = torch.zeros(1, 4, 2, 0)
        args, err = (empty, empty, empty), ValueError
    elif bad == "dtype":
        h = torch.zeros(1, 4, 2, 8, dtype=torch.float16)
        args, err = (h, h, h), TypeError
    else:
        args, err = (q, k[:, :, :, :4], k), ValueError
    with pytest.raises(err):
        flash_attention_fwd(*args)


def _attn_params(name, *, cross=False):
    """The reference's ``attn_init`` weights for smoke config ``name``, as
    (jax config, port config, jax params, port params)."""
    import dataclasses
    import jax
    from repro.configs import get_smoke_config
    from repro.models.attention import attn_init
    from repro_torch.models import ModelConfig
    jcfg = get_smoke_config(name)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = attn_init(jax.random.PRNGKey(3), jcfg, cross=cross)
    if not cross and cfg.qk_norm:        # nonzero norm scales
        jp = dict(jp, q_scale=jp["q_scale"] + 0.3, k_scale=jp["k_scale"] - 0.2)
    return jcfg, cfg, jp, {k: torch.from_numpy(np.array(v))
                           for k, v in jp.items()}


def _k4_calls(monkeypatch):
    """Record the causal flag and shapes of every call of K4's wrapper
    from the model's attention."""
    calls = []
    wrapped = MA.attn_kernel.flash_attention_fwd

    def spy(q, k, v, *, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return wrapped(q, k, v, causal=causal)
    monkeypatch.setattr(MA.attn_kernel, "flash_attention_fwd", spy)
    return calls


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["whisper-tiny", "qwen3-moe-235b-a22b",
                                  "mixtral-8x7b"])
def test_attn_train_matches_reference(name, causal, rng, monkeypatch):
    """The forward of ``attn_train``: RoPE, qk-norm (qwen3) and, with no
    window, K4 with the given ``causal`` (the whisper encoder's is
    False); mixtral's "local" kind takes the banded plain path."""
    from repro.models.attention import attn_train as j_train
    jcfg, cfg, jp, tp = _attn_params(name)
    kind = cfg.block_pattern[0]
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    calls = _k4_calls(monkeypatch)
    got = MA.attn_train(tp, torch.from_numpy(x), cfg, kind, causal=causal)
    want = j_train(jp, jnp.asarray(x), jcfg, kind, causal=causal)
    _close(got, want, _TOL["float32"])
    if kind == "local":
        assert calls == []
    else:
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        assert calls == [((2, 37, h, dh), (2, 37, kv, dh), causal)]


@pytest.mark.parametrize("te", [50, 23])
def test_cross_attn_train_matches_reference(te, rng, monkeypatch):
    """Decoder queries over encoder keys: no RoPE, no mask, K4 non-causal
    with Tq != Tk; the cross cache is the un-rotated k and v."""
    from repro.models.attention import cross_attn_train as j_cross
    jcfg, cfg, jp, tp = _attn_params("whisper-tiny", cross=True)
    assert "q_scale" not in tp
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, te, cfg.d_model)).astype(np.float32)
    calls = _k4_calls(monkeypatch)
    y, cache = MA.cross_attn_train(tp, torch.from_numpy(x),
                                   torch.from_numpy(enc), cfg)
    jy, jcache = j_cross(jp, jnp.asarray(x), jnp.asarray(enc), jcfg)
    _close(y, jy, _TOL["float32"])
    assert sorted(cache) == ["k", "v"]
    for key in ("k", "v"):
        _close(cache[key], jcache[key], _TOL["float32"])
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    assert calls == [((2, 37, h, dh), (2, te, kv, dh), False)]


def test_plain_version_keeps_its_autograd_on_the_host(rng):
    """K4's wrapper on CPU tensors that require grad is the plain version
    with its autograd (the CUDA route refuses them until K4 has a
    backward: ROADMAP.md queue 1, item 4): the gradients are those of the
    same attention written out in float64."""
    (_, q), (_, k), (_, v) = _qkv(rng, 1, 6, 6, 4, 2, 8, "float32")
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention_fwd(*ins).square().sum().backward()
    ref = [t.double().clone().requires_grad_(True) for t in (q, k, v)]
    qh = ref[0].reshape(1, 6, 2, 2, 8) * 8 ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, ref[1])
    s = s.masked_fill(torch.ones(6, 6, dtype=torch.bool).triu(1), -1e30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", s.softmax(-1), ref[2])
    o.reshape(1, 6, 4, 8).square().sum().backward()
    for a, b in zip(ins, ref):
        assert a.grad is not None
        assert torch.allclose(a.grad.double(), b.grad, atol=1e-5)
