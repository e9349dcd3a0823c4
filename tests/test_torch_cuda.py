"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip here, without a card or ``nvcc`` (a CUDA kernel
has no host mode; ``tests/test_torch_kernels.py`` holds the plain versions
against the JAX reference on the CPU). On a machine with a card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no JAX, so it runs where only PyTorch is installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import greedy as G  # noqa: E402
from repro_torch.kernels.pg import pg as PK  # noqa: E402
from repro_torch.kernels.resize import resize as PR  # noqa: E402


@pytest.fixture
def rng():
    """A generator seeded in each test: ``tests/conftest.py``'s ``rng`` is
    shared by the session, so its draws would depend on which tests ran
    before in the same worker."""
    return np.random.default_rng(0)


def _random_round(rng, b, t, a, m, occupied_frac=0.5):
    grid = rng.uniform(1, 10, (a, m)).astype(np.float32)
    price = rng.uniform(0.1, 1, (b, m)).astype(np.float32)
    cap = rng.uniform(20, 40, (b, m)).astype(np.float32)
    occ = (rng.uniform(0, 5, (b, m))
           * (rng.random((b, m)) < occupied_frac)).astype(np.float32)
    lat = rng.random((b, t, a)) < 0.3
    alive = rng.random((b, t)) < 0.7
    return lat, alive, grid, price, cap, occ


def _bf16_excess(out, ref):
    """K4's bf16 tolerance, as ``chip_smoke.py``'s ``K4_BF16_TOL``: each
    element of ``out`` within 2^-7 |ref| + 2^-6 rms(ref's row over Dh) of
    ``ref``, the plain version in float32 on the same inputs (twice the
    output's half-ulp rounding, plus the bf16 P's error, which scales with
    the row: a row averaging 1500 keys is held as tightly as a short one).
    Returns the largest share of it; at most 1 passes."""
    ref = ref.float()
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    return ((out.float() - ref).abs()
            / (2 ** -7 * ref.abs() + 2 ** -6 * rms)).max().item()


@pytest.fixture
def cuda_device():
    if not kernels.available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernels have no "
                    "host mode (tests/test_torch_kernels.py tests their plain "
                    "versions)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,a,m", [(1, 1, 1, 2), (5, 37, 97, 2),
                                     (4, 26, 129, 4), (64, 32, 300, 2),
                                     (3, 7, 2560, 9), (2, 5, 19200, 4)])
def test_round_kernel_matches_plain_on_card(b, t, a, m, cuda_device, rng):
    ins = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
           for x in _random_round(rng, b, t, a, m)]
    ref = PK.batch_round_ref(*ins)
    before = PK.ROUND_KERNEL.launches
    out = PK.batch_round(G._pack_bits(ins[0]), *ins[1:])
    torch.cuda.synchronize()
    assert PK.ROUND_KERNEL.launches == before + 1
    assert torch.equal(out[0].view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])


@pytest.mark.cuda
@pytest.mark.parametrize("t,a", [(1, 1), (37, 97), (50, 300), (200, 1280),
                                 (1031, 999)])
def test_argmax_kernel_matches_plain_on_card(t, a, cuda_device, rng):
    sel = (rng.integers(-4, 4, a) * 0.25).astype(np.float32)   # ties
    lat = rng.random((t, a)) < 0.35
    lat[::5] = False                                           # all masked
    alive = rng.random(t) < 0.8
    alive[1::7] = False                                        # dead rows
    for cap in (rng.random(a) < 0.7, np.zeros(a, bool)):
        ins = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
               for x in (sel, lat, cap, alive)]
        ref = PK.masked_argmax_ref(*ins)
        before = PK.ARGMAX_KERNEL.launches
        out = PK.masked_argmax(*ins)
        torch.cuda.synchronize()
        assert PK.ARGMAX_KERNEL.launches == before + 1
        assert torch.equal(out[0].view(torch.int32), ref[0].view(torch.int32))
        assert torch.equal(out[1], ref[1])


@pytest.mark.cuda
def test_single_solve_kernel_matches_torch_round_on_card(cuda_device):
    from repro_torch.core import scenarios, solve_greedy_torch
    for inst in scenarios.fig6_sweep(4, n_tasks=(20, 50), seeds=(0,))[0][::5]:
        for sem in (True, False):
            for flex in (True, False):
                a = solve_greedy_torch(inst, semantic=sem, flexible=flex,
                                       inner="kernel", device=cuda_device)
                b = solve_greedy_torch(inst, semantic=sem, flexible=flex,
                                       inner="torch", device=cuda_device)
                assert np.array_equal(a.admitted, b.admitted)
                assert np.array_equal(a.alloc, b.alloc)


def _round_on_card(inst, semantic, flexible, dev):
    """Step the round kernel and its plain version (on copies of one state,
    on the card) through a whole solve of ``inst``, comparing every state
    tensor bitwise after every round. Returns the rounds run."""
    from repro_torch.core.sfesp import _f32, lexicographic_cost
    lat, z_idx = G._select_tables(inst, semantic)
    lat_ok = lat <= inst.tasks.max_latency[:, None]
    tables = (torch.from_numpy(lat_ok).to(dev), _f32(inst.grid, dev),
              _f32(inst.pool.price, dev), _f32(inst.pool.capacity, dev),
              _f32(lexicographic_cost(inst.grid), dev))
    t = lat.shape[0]
    state = (torch.zeros(t, dtype=torch.bool, device=dev),
             torch.full((t,), -1, dtype=torch.int32, device=dev),
             torch.zeros(inst.m, dtype=torch.float32, device=dev),
             torch.from_numpy((z_idx >= 0) & lat_ok.any(axis=1)).to(dev))
    plain = tuple(x.clone() for x in state)
    step = PK.bind_round(state, *tables, flexible=flexible)
    rounds = 0
    while True:
        done = not bool(state[3].any())
        before = PK.ADMIT_KERNEL.launches
        step()
        PK.admission_round_ref(plain, *tables, flexible)
        torch.cuda.synchronize()
        assert PK.ADMIT_KERNEL.launches == before + 1
        rounds += 1
        for x, y in zip(state, plain):
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), f"round {rounds}"
        if done:
            return rounds


@pytest.mark.cuda
@pytest.mark.parametrize("semantic,flexible", [(True, True), (True, False),
                                               (False, True),
                                               (False, False)])
def test_admission_round_kernel_matches_plain_on_card(semantic, flexible,
                                                      cuda_device):
    """The round kernel against its plain version on every round of one
    T = 200, A = 1280 solve (the paper's largest instance)."""
    from repro_torch.core import build_instance, scenarios
    inst = build_instance(scenarios.numerical_pool(4),
                          scenarios.numerical_tasks(200, "med", "high"))
    assert _round_on_card(inst, semantic, flexible, cuda_device) > 2


def _tap_gather(img, h, w):
    """K3's arithmetic on ``resize_taps`` as plain torch ops (rows first,
    every product and sum rounded to float32): bitwise what the kernel
    computes if its in-kernel taps equal ``resize_taps``."""
    (ih, wh), (iw, ww) = (
        (torch.from_numpy(i).long().to(img.device),
         torch.from_numpy(wt).to(img.device))
        for i, wt in (PR.resize_taps(h, img.shape[1]),
                      PR.resize_taps(w, img.shape[2])))
    x = img.float()
    a0, a1 = wh[0][None, :, None, None], wh[1][None, :, None, None]
    b0, b1 = ww[0][None, None, :, None], ww[1][None, None, :, None]
    rows = (a0 * x[:, ih[0]], a1 * x[:, ih[1]])
    t0 = rows[0][:, :, iw[0]] + rows[1][:, :, iw[0]]
    t1 = rows[0][:, :, iw[1]] + rows[1][:, :, iw[1]]
    return (b0 * t0 + b1 * t1).to(img.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resize_kernel_matches_plain_on_card(dtype, cuda_device, rng):
    """K3 with its taps derived in the kernel: within 1e-5 (float32) or
    3e-2 (bfloat16) of the plain einsum, bitwise equal to the same gather
    on ``resize_taps``."""
    img = torch.from_numpy(rng.standard_normal((3, 17, 31, 4)).astype(
        np.float32)).to(cuda_device, dtype)
    for z in (1.0, 0.5, 0.04):
        ho, wo = PR.out_size_for_z(17, 31, z)
        before = PR.RESIZE_KERNEL.launches
        out = PR.resize_bilinear(img, ho, wo)
        ref = PR.resize_bilinear_ref(img, ho, wo)
        torch.cuda.synchronize()
        assert PR.RESIZE_KERNEL.launches == before + 1
        tol = 1e-5 if dtype == torch.float32 else 3e-2
        assert torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
        assert torch.equal(out, _tap_gather(img, ho, wo))


@pytest.mark.cuda
@pytest.mark.parametrize("flexible", [True, False])
def test_admission_round_kernel_at_m9_on_card(flexible, cuda_device):
    """K2's round at nine resources (the m = 4 numerical pool plus five unit
    resources, A = 2560): every round bitwise its plain version."""
    from repro_torch.core import ResourcePool, build_instance, scenarios
    p4 = scenarios.numerical_pool(4)
    pool = ResourcePool(
        names=p4.names + tuple(f"unit{i}" for i in range(5)),
        capacity=np.concatenate([p4.capacity, np.full(5, 12.0)]),
        price=np.concatenate([p4.price, np.full(5, 1 / 12)]),
        levels=tuple(p4.levels) + (np.array([1.0]),) * 4
        + (np.array([1.0, 2.0]),))
    inst = build_instance(pool, scenarios.numerical_tasks(30, "med", "high",
                                                          seed=3))
    assert inst.grid.shape == (2560, 9)
    assert _round_on_card(inst, True, flexible, cuda_device) > 2


def _solve_stack(rng, b, t, a, m, dev, group=8, coupled=True):
    """A random DeviceStack for K1's solve with planted ties (duplicated
    lanes, all-zero prices, duplicated task rows), cells with nothing
    feasible or nothing alive; coupled: contiguous groups of ``group`` cells
    on one link each, and a second link per half group (``group`` = 0: one
    group of 20 cells, the rest uncoupled singletons)."""
    from repro_torch.core import CouplingSpec
    from repro_torch.core.sfesp import (DeviceStack, group_csr,
                                        lexicographic_cost)
    grid = rng.integers(1, 16, (a, m)).astype(np.float32)
    grid[a // 2:a // 2 + 8] = grid[:8]
    price = rng.uniform(0.02, 0.2, (b, m)).astype(np.float32)
    price[::7] = 0.0
    cap = rng.integers(8, 30, (b, m)).astype(np.float32)
    lat = rng.random((b, t, a)) < 0.2
    lat[1::5, 1::2] = lat[1::5, 0::2][:, :t // 2]
    lat[3::11] = False
    alive0 = lat.any(2) & (rng.random((b, t)) < 0.9)
    alive0[5::13] = False
    load = rng.uniform(0.05, 0.5, (b, t)).astype(np.float32)
    link = dict(link_cap=None, incidence=None, group=None, group_csr=None)
    if coupled:
        if group:
            n = b // group
            inc = np.zeros((b, n + 2 * n), bool)
            inc[np.arange(b), np.arange(b) // group] = True
            inc[np.arange(b), n + np.arange(b) // max(1, group // 2)] = True
        else:
            inc = np.zeros((b, 1), bool)
            inc[:20, 0] = True
        budgets = rng.uniform(0.5, 2.0, inc.shape[1]) * inc.sum(0)
        groups = CouplingSpec(budgets, inc).groups()
        link = dict(link_cap=torch.tensor(budgets, dtype=torch.float32,
                                          device=dev),
                    incidence=torch.from_numpy(inc).to(dev),
                    group=torch.from_numpy(groups).to(dev),
                    group_csr=group_csr(inc, groups, dev))
    f32 = (lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(
        dev, torch.float32))
    return DeviceStack(grid=f32(grid), cost=f32(lexicographic_cost(grid)),
                       price=f32(price), capacity=f32(cap),
                       lat_ok=torch.from_numpy(lat).to(dev),
                       alive0=torch.from_numpy(alive0).to(dev),
                       link_load=f32(load), semantic=True, batch_size=b,
                       **link)


@pytest.mark.cuda
@pytest.mark.parametrize("what,b,t,a,m,group,coupled", [
    ("groups of 8", 64, 32, 300, 2, 8, True),
    ("group of 20 + singletons", 40, 16, 300, 2, 0, True),
    ("uncoupled", 24, 32, 300, 2, 8, False),
    ("m = 9", 16, 16, 2560, 9, 4, True),
    ("A = 19200", 8, 8, 19200, 4, 4, True)])
def test_batch_solve_matches_plain_on_card(what, b, t, a, m, group, coupled,
                                           cuda_device, rng):
    """K1's whole solve in one launch against its plain version (the host
    loop over the torch round) on the card: admitted, alloc_idx, occupied
    and the link budget used bit for bit; the loop's round count is the
    kernel's largest group count rounded up to the loop's period."""
    dev = _solve_stack(rng, b, t, a, m, cuda_device, group, coupled)
    before = PK.SOLVE_KERNEL.launches
    out = PK.batch_solve(dev)
    ref = PK.batch_solve_ref(dev)
    torch.cuda.synchronize()
    assert PK.SOLVE_KERNEL.launches == before + 1
    for name, x, y in zip(("admitted", "alloc_idx", "occupied", "used"),
                          out[:4], ref[:4]):
        if y is None:
            assert x is None
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{what}: {name}"
    period = G._SYNC_EVERY
    assert int(ref[4][0]) == period * -(-int(out[4].max()) // period)
    assert out[0].any()


@pytest.mark.cuda
def test_flexible_dispatch_is_one_solve_launch_on_card(cuda_device, rng):
    """On the card a flexible batched solve is one ``batch_solve`` launch,
    no one-round launch, one host sync (the read-back), and decides as the
    ``inner="torch"`` twin."""
    dev = _solve_stack(rng, 64, 32, 300, 2, cuda_device)
    solve, rnd = PK.SOLVE_KERNEL.launches, PK.ROUND_KERNEL.launches
    got = G.solve_device_batch(dev)
    assert PK.SOLVE_KERNEL.launches == solve + 1
    assert PK.ROUND_KERNEL.launches == rnd
    assert got["syncs"] == 1
    want = G.solve_device_batch(dev, inner="torch")
    for key in ("admitted", "alloc_idx", "residual", "link_used"):
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.cuda
def test_kernels_launch_on_the_callers_stream_on_card(cuda_device, rng):
    """A launch made while a side stream is current runs on that stream:
    queued behind a sleep and a copy on the side stream, K3 and the round
    kernel read the copied data (the legacy default stream would not wait
    for them)."""
    from repro_torch.core import build_instance, scenarios
    src = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(
        np.float32)).to(cuda_device)
    img = torch.zeros_like(src)
    side = torch.cuda.Stream(cuda_device)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        img.copy_(src)
        out = PR.resize_bilinear(img, 13, 13)
    side.synchronize()
    assert torch.equal(out, PR.resize_bilinear(src, 13, 13))

    inst = build_instance(scenarios.numerical_pool(2),
                          scenarios.numerical_tasks(30, "med", "high"))
    lat_ok = torch.from_numpy(inst.lat <= inst.tasks.max_latency[:, None])
    alive0 = lat_ok.any(1) & torch.from_numpy(inst.z_star_idx >= 0)
    tables = [x.to(cuda_device) for x in (
        lat_ok, torch.from_numpy(inst.grid).float(),
        torch.from_numpy(inst.pool.price).float(),
        torch.from_numpy(inst.pool.capacity).float(),
        torch.from_numpy(inst.grid @ np.ones(2)).float())]
    state = (torch.zeros(30, dtype=torch.bool, device=cuda_device),
             torch.full((30,), -1, dtype=torch.int32, device=cuda_device),
             torch.zeros(2, device=cuda_device),
             torch.zeros(30, dtype=torch.bool, device=cuda_device))
    alive0 = alive0.to(cuda_device)
    want = tuple(x.clone() for x in state[:3]) + (alive0.clone(),)
    step = PK.bind_round(state, *tables, flexible=True)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        state[3].copy_(alive0)
        step()
    side.synchronize()
    PK.admission_round_ref(want, *tables, True)
    assert state[0].any()
    for x, y in zip(state, want):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,hq,hkv,dh,causal", [
    (8, 16, 16, 32, 2, 128, True), (1, 1000, 1000, 32, 2, 128, True),
    (2, 77, 77, 32, 8, 120, True), (2, 333, 333, 16, 8, 256, True),
    (1, 1, 1, 4, 4, 16, True), (2, 33, 33, 4, 2, 16, True),
    (2, 24, 40, 4, 2, 8, False), (1, 130, 17, 6, 3, 64, False),
    # the whisper-tiny encoder, cross-attention and decoder, qwen3-moe's
    # 64 query over 4 KV heads
    (2, 1500, 1500, 6, 6, 64, False), (2, 448, 1500, 6, 6, 64, False),
    (2, 448, 448, 6, 6, 64, True), (2, 2048, 2048, 64, 4, 128, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(b, tq, tk, hq, hkv, dh, causal,
                                            dtype, cuda_device, rng):
    """K4 against its plain version on unit normals, through the route
    ``flash_attention_fwd`` takes: float32 on the CUDA-core kernel within
    2e-5 (sums in another order); bfloat16 (every Dh here is a multiple of
    8) on the tensor-core kernel within ``_bf16_excess``'s tolerance of the
    plain version in float32."""
    from repro_torch.kernels.attn import attn as PA
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, dtype)
               for s in ((b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh)))
    ref = PA.flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                     causal=causal)
    routed = PA.FLASH_TC_KERNEL if dtype == torch.bfloat16 \
        else PA.FLASH_CORE_KERNEL
    before, routed_before = PA.FLASH_KERNEL.launches, routed.launches
    out = PA.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert PA.FLASH_KERNEL.launches == before + 1
    assert routed.launches == routed_before + 1
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        assert torch.allclose(out, ref, rtol=0, atol=2e-5)
    else:
        assert _bf16_excess(out, ref) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_wide_heads_on_card(dtype, cuda_device, rng):
    """Dh = 320 goes to the CUDA-core kernel's Dh <= 512 tile in both
    types (the tensor-core tiles stop at 256), within 2e-5 (f32) and
    ``_bf16_excess``'s tolerance (bf16 in and out) of the plain version in
    float32; Dh = 520 raises."""
    from repro_torch.kernels.attn import attn as PA
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, dtype)
               for s in ((2, 77, 8, 320), (2, 77, 4, 320), (2, 77, 4, 320)))
    ref = PA.flash_attention_fwd_ref(q.float(), k.float(), v.float())
    before = PA.FLASH_CORE_KERNEL.launches
    out = PA.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert PA.FLASH_CORE_KERNEL.launches == before + 1
    if dtype == torch.float32:
        assert torch.allclose(out, ref, rtol=0, atol=2e-5)
    else:
        assert _bf16_excess(out, ref) <= 1.0
    wide = torch.zeros(1, 4, 2, 520, device=cuda_device, dtype=dtype)
    with pytest.raises(ValueError, match="520"):
        PA.flash_attention_fwd(wide, wide, wide)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,hq,hkv,dh", [(8, 16, 32, 2, 128),
                                           (3, 5, 8, 1, 64),
                                           (2, 16, 16, 8, 120)])
def test_tc_kernel_packs_short_prompts_on_card(b, t, hq, hkv, dh,
                                               cuda_device, rng):
    """Short prompts pack a KV head's G query heads into one 64-row tile
    (row r is head r // T at t = r % T): the tensor-core kernel against the
    plain version (in float32) and the CUDA-core kernel on the same bf16
    inputs, within ``_bf16_excess``'s tolerance."""
    from repro_torch.kernels.attn import attn as PA
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, torch.bfloat16)
               for s in ((b, t, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh)))
    before = PA.FLASH_TC_KERNEL.launches
    out = PA.launch("tensor_cores", q, k, v)
    core = PA.launch("cuda_cores", q, k, v)
    torch.cuda.synchronize()
    assert PA.FLASH_TC_KERNEL.launches == before + 1
    for want in (PA.flash_attention_fwd_ref(q.float(), k.float(),
                                            v.float()), core):
        assert _bf16_excess(out, want) <= 1.0


@pytest.mark.cuda
def test_tc_kernel_refuses_unaligned_inputs_on_card(cuda_device):
    """TMA reads from 16-byte-aligned bases: an unaligned bf16 view raises
    instead of launching."""
    from repro_torch.kernels.attn import attn as PA
    flat = torch.zeros(1 + 2 * 4 * 2 * 16, device=cuda_device,
                       dtype=torch.bfloat16)
    q = flat[1:].view(2, 4, 2, 16)
    before = PA.FLASH_KERNEL.launches
    with pytest.raises(ValueError, match="16-byte"):
        PA.flash_attention_fwd(q, q, q)
    assert PA.FLASH_KERNEL.launches == before


@pytest.mark.cuda
def test_prefill_through_the_kernel_on_card(cuda_device):
    """A chatglm3-geometry smoke model's prefill on the card (K4) against
    the same prefill on the host (K4's plain version), float32: logits
    within 2e-5, caches within 5e-5 (other sums of the projections)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.models import init_params, prefill
    cfg = reduce_for_smoke(get_config("chatglm3-6b"), n_heads=32,
                           n_kv_heads=2, d_head=128)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 37), dtype=np.int32))
    want, wcache = prefill(params, {"tokens": toks}, cfg, cache_len=40)

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(cuda_device)
    dev = to_card(params)
    before = PA.FLASH_KERNEL.launches
    got, gcache = prefill(dev, {"tokens": toks.to(cuda_device)}, cfg,
                          cache_len=40)
    torch.cuda.synchronize()
    assert PA.FLASH_KERNEL.launches == before + cfg.n_layers
    assert torch.allclose(got.cpu(), want, rtol=0, atol=2e-5)
    for i in range(cfg.n_repeats):
        for n in ("k", "v"):
            assert torch.allclose(gcache["scan"]["pos0"][n][i].cpu(),
                                  wcache["scan"]["pos0"][n][i], rtol=1e-5,
                                  atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name,k4", [("mixtral-8x7b", 0),
                                     ("qwen3-moe-235b-a22b", 2),
                                     ("recurrentgemma-9b", 0),
                                     ("rwkv6-1.6b", 0), ("whisper-tiny", 6)])
def test_slice8_prefill_on_card_matches_host(name, k4, cuda_device):
    """The MoE, RG-LRU, RWKV and encoder-decoder smoke models' prefill on
    the card against the same prefill on the host, float32: logits within
    2e-5, caches within 5e-5 plus 1e-5 relative (other sums of the
    products). K4 launches: one a full-attention layer (whisper: 2
    encoder, 2 decoder self- and 2 cross-attention layers)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.models import init_params, prefill
    cfg = get_smoke_config(name)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 37), dtype=np.int32))}
    if cfg.is_encdec:
        batch["enc_input"] = torch.from_numpy(rng.standard_normal(
            (2, 50, cfg.d_model)).astype(np.float32))
    want, wcache = prefill(params, batch, cfg, cache_len=40)

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(to_card(v) for v in tree)
        return tree.to(cuda_device)

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, tuple):
            return [x for v in tree for x in leaves(v)]
        return [tree]
    before = PA.FLASH_KERNEL.launches
    got, gcache = prefill(to_card(params), to_card(batch), cfg,
                          cache_len=40)
    torch.cuda.synchronize()
    assert PA.FLASH_KERNEL.launches == before + k4
    assert torch.allclose(got.cpu(), want, rtol=0, atol=2e-5)
    for g, w in zip(leaves(gcache), leaves(wcache), strict=True):
        assert torch.allclose(g.cpu(), w, rtol=1e-5, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 8])
def test_sharded_solve_on_one_card_is_one_launch_on_card(n, cuda_device):
    """n shards of one card: the sharded solve decides as the meshless
    ``solve_greedy_batch`` bit for bit, with one ``batch_solve`` launch per
    solve (one device, one launch) and no one-round launch."""
    from repro_torch.core import (scenarios, solve_greedy_batch,
                                  solve_greedy_sharded)
    from repro_torch.launch.mesh import make_cells_mesh
    insts, _ = scenarios.metro_diurnal_trace(64, n_domains=8, hours=(13,))
    want = solve_greedy_batch(insts, device=cuda_device)
    mesh = make_cells_mesh(n, devices=[cuda_device])
    solve, rnd = PK.SOLVE_KERNEL.launches, PK.ROUND_KERNEL.launches
    got = solve_greedy_sharded(insts, mesh=mesh)
    assert PK.SOLVE_KERNEL.launches == solve + 1
    assert PK.ROUND_KERNEL.launches == rnd
    for a, b in zip(want, got):
        assert np.array_equal(a.admitted, b.admitted)
        assert np.array_equal(a.alloc, b.alloc)
        assert np.array_equal(a.z, b.z)
    twin = solve_greedy_sharded(insts, mesh=mesh, inner="torch")
    for a, b in zip(twin, got):
        assert np.array_equal(a.admitted, b.admitted)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("name,k4", [("chatglm3-6b", 2), ("gemma3-12b", 1),
                                     ("mixtral-8x7b", 0),
                                     ("qwen3-moe-235b-a22b", 2),
                                     ("recurrentgemma-9b", 0),
                                     ("rwkv6-1.6b", 0), ("whisper-tiny", 6)])
def test_decode_on_card_matches_host(name, k4, cuda_device):
    """Each kind's decode on the card: a smoke model's prefill (K4 on its
    full-attention layers) and 5 ``decode_step``s, the last at ``pos ==
    cache_len``, against the same computation on the host, float32:
    logits and every cache leaf within 1e-4 plus 1e-5 relative (other
    sums of the products). Decode launches no K4, and leaves the cache it
    was given unchanged."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.attn import attn as PA
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_smoke_config(name)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 42),
                                         dtype=np.int32))
    batch = {"tokens": toks[:, :37]}
    if cfg.is_encdec:
        batch["enc_input"] = torch.from_numpy(rng.standard_normal(
            (2, 50, cfg.d_model)).astype(np.float32))

    def run(p, b, dev):
        lg, cache = prefill(p, b, cfg, cache_len=41)
        out = [(lg, cache)]
        for j in range(5):
            lg, cache = decode_step(p, cache, toks[:, 37 + j].to(dev),
                                    37 + j, cfg)
            out.append((lg, cache))
        return out
    want = run(params, batch, "cpu")
    dparams = _to(params, cuda_device)
    before = PA.FLASH_KERNEL.launches
    got = run(dparams, _to(batch, cuda_device), cuda_device)
    torch.cuda.synchronize()
    assert PA.FLASH_KERNEL.launches == before + k4
    for (gl, gc), (wl, wc) in zip(got, want, strict=True):
        assert torch.allclose(gl.cpu(), wl, rtol=1e-5, atol=1e-4)
        for g, w in zip(_leaves(gc), _leaves(wc), strict=True):
            assert g.device.type == "cuda"
            assert torch.allclose(g.cpu(), w, rtol=1e-5, atol=1e-4)
    cache = got[0][1]
    keep = [t.clone() for t in _leaves(cache)]
    decode_step(dparams, cache, toks[:, 37].to(cuda_device), 37, cfg)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(cache), keep))


@pytest.mark.cuda
def test_flash_kernel_refuses_inputs_that_require_grad_on_card(cuda_device,
                                                               rng):
    """A CUDA input that requires grad, under grad mode, goes through
    ``FlashAttention``: K4 launches once (writing the LSE) and the output
    carries K4′'s gradient (three launches on its tensor-core route, bf16
    at Dh 64), equal to ``flash_attention_bwd``'s given K4's LSE; under
    ``no_grad`` K4 launches and the output needs no grad. (The name is
    kept from before K4′, when such an input raised.)"""
    from repro_torch.kernels.attn import attn as PA
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, 64)).astype(
        np.float32)).to(cuda_device).bfloat16()
    k = q[:, :, :2].contiguous()
    route = PA.bwd_route(q.dtype, q.shape[-1])
    assert route == "tensor_cores"
    for which in range(3):
        args = [q.clone(), k.clone(), k.clone()]
        args[which].requires_grad_(True)
        before = PA.FLASH_KERNEL.launches
        bwd_before = PA.FLASH_BWD_TC_KERNEL.launches
        out = PA.flash_attention_fwd(*args)
        assert out.requires_grad
        dout = torch.ones_like(out)
        out.backward(dout)
        torch.cuda.synchronize()
        assert PA.FLASH_KERNEL.launches == before + 1
        assert PA.FLASH_BWD_TC_KERNEL.launches \
            == bwd_before + PA.BWD_PASSES[route]
        plain = [a.detach() for a in args]
        _, lse = PA.launch("tensor_cores", *plain, with_lse=True)
        want = PA.flash_attention_bwd(*plain, out.detach(), dout, lse=lse)
        assert torch.equal(args[which].grad, want[which])
        with torch.no_grad():
            out = PA.flash_attention_fwd(*args)
        torch.cuda.synchronize()
        assert PA.FLASH_KERNEL.launches == before + 3
        assert not out.requires_grad


# K4′ on the card against its plain version in float32 on the same inputs,
# element by element within a |ref| + b rms(ref's row) + c rms(ref), as
# chip_smoke.py's K4B_BF16_TOL, K4B_F32_TOL and K4B_TC_TOL: the CUDA-core
# route in bf16 (2^-7, 2^-10, 2^-16), twice the outputs' rounding plus
# float32's order; float32 (2^-14, 2^-14, 2^-14), the order alone (the c
# floor for rows that cancel, causal dq row 0); the tensor-core route
# (2^-7, 2^-6, 2^-14), its P and dS rounded to bf16 before their products
_BWD_TOL = {torch.bfloat16: (2 ** -7, 2 ** -10, 2 ** -16),
            torch.float32: (2 ** -14, 2 ** -14, 2 ** -14)}
_BWD_TC_TOL = (2 ** -7, 2 ** -6, 2 ** -14)


def _bwd_within(got, ref, tol):
    a, r, c = tol
    for g, w in zip(got, ref):
        rms = w.pow(2).mean(-1, keepdim=True).sqrt()
        bound = a * w.abs() + r * rms + c * w.pow(2).mean().sqrt()
        assert ((g.float() - w).abs() <= bound).all(), \
            float(((g.float() - w).abs() / bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,hq,hkv,dh,causal", [
    (2, 77, 77, 8, 2, 64, True), (1, 33, 33, 4, 1, 128, True),
    (2, 40, 100, 6, 6, 64, False), (1, 130, 130, 4, 2, 256, True),
    (1, 21, 50, 4, 4, 320, False), (1, 1, 1, 2, 1, 16, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_matches_plain_on_card(b, tq, tk, hq, hkv, dh,
                                                causal, dtype, cuda_device,
                                                rng):
    """K4′ against ``flash_attention_bwd_ref`` at Dh 16–320, G 1–4,
    Tq != Tk and lengths not a multiple of a tile, on the route
    ``flash_attention_bwd`` takes (bf16 at Dh 16, 64 and 128:
    ``csrc/flash_attn_bwd_tc.cu``, given K4's LSE; the rest
    ``csrc/flash_attn_bwd.cu``): a launch a pass on that route's kernel, a
    repeat bit for bit, within ``_BWD_TC_TOL`` or ``_BWD_TOL``."""
    from repro_torch.kernels.attn import attn as PA
    dt = getattr(torch, dtype)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, dt)
    q, k, v = draw(b, tq, hq, dh), draw(b, tk, hkv, dh), draw(b, tk, hkv, dh)
    dout = draw(b, tq, hq, dh)
    route = PA.bwd_route(dt, dh)
    lse = None
    if route == "tensor_cores":
        out, lse = PA.launch("tensor_cores", q, k, v, causal=causal,
                             with_lse=True)
    else:
        out = PA.flash_attention_fwd(q, k, v, causal=causal)
    counter = PA.FLASH_BWD_TC_KERNEL if route == "tensor_cores" \
        else PA.FLASH_BWD_CORE_KERNEL
    before, total = counter.launches, PA.FLASH_BWD_KERNEL.launches
    got = PA.flash_attention_bwd(q, k, v, out, dout, causal=causal, lse=lse)
    again = PA.flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                   lse=lse)
    torch.cuda.synchronize()
    assert counter.launches == before + 2 * PA.BWD_PASSES[route]
    assert PA.FLASH_BWD_KERNEL.launches == total + 2 * PA.BWD_PASSES[route]
    ref = PA.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                     out.float(), dout.float(), causal=causal)
    for g, g2, like in zip(got, again, (q, k, v)):
        assert torch.equal(g, g2)
        assert g.dtype == dt and g.shape == like.shape
    _bwd_within(got, ref, _BWD_TC_TOL if route == "tensor_cores"
                else _BWD_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,hq,hkv,dh,causal", [
    (2, 256, 256, 16, 2, 128, True), (2, 77, 77, 8, 2, 64, True),
    (1, 130, 130, 4, 2, 120, True), (2, 40, 100, 6, 6, 64, False),
    (1, 1, 1, 2, 1, 16, True)])
def test_flash_bwd_tc_kernel_matches_plain_on_card(b, tq, tk, hq, hkv, dh,
                                                   causal, cuda_device, rng):
    """The tensor-core K4′ (``csrc/flash_attn_bwd_tc.cu``) given K4's LSE
    against the plain version within ``_BWD_TC_TOL``, and the CUDA-core
    kernel held on the same bf16 inputs (``bwd_launch``) within
    ``_BWD_TOL`` — without the LSE and given the plain version's. K4's
    output is bit for bit the same with its LSE written or not, and the
    LSE within 2^-8 of the plain LSE. ``FlashAttention``'s backward is bit
    for bit the direct call given the same LSE."""
    from repro_torch.kernels.attn import attn as PA

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = draw(b, tq, hq, dh), draw(b, tk, hkv, dh), draw(b, tk, hkv, dh)
    dout = draw(b, tq, hq, dh)
    assert PA.bwd_route(q.dtype, dh) == "tensor_cores"
    out, lse = PA.launch("tensor_cores", q, k, v, causal=causal,
                         with_lse=True)
    assert torch.equal(out, PA.launch("tensor_cores", q, k, v,
                                      causal=causal))
    _, ref_lse = PA.flash_attention_fwd_ref(
        q.float(), k.float(), v.float(), causal=causal, with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, tq)
    assert (lse - ref_lse).abs().max().item() <= 2 ** -8
    ref = PA.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                     out.float(), dout.float(), causal=causal)
    _bwd_within(PA.flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                       lse=lse), ref, _BWD_TC_TOL)
    _bwd_within(PA.bwd_launch("cuda_cores", q, k, v, out, dout,
                              causal=causal), ref, _BWD_TOL[torch.bfloat16])
    _bwd_within(PA.bwd_launch("cuda_cores", q, k, v, out, dout,
                              causal=causal, lse=ref_lse), ref,
                _BWD_TOL[torch.bfloat16])
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    PA.flash_attention_fwd(*ins, causal=causal).backward(dout)
    want = PA.flash_attention_bwd(q, k, v, out, dout, causal=causal, lse=lse)
    torch.cuda.synchronize()
    for t, w in zip(ins, want):
        assert torch.equal(t.grad, w)


_FIRST_BACKWARD = """
import threading
import numpy as np
import torch
from repro_torch.kernels.attn import attn as PA
rng = np.random.default_rng(0)
q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .cuda().bfloat16() for s in ((1, 64, 4, 64), (1, 64, 2, 64),
                                               (1, 64, 2, 64), (1, 64, 4, 64)))
out, lse = PA.launch("tensor_cores", q, k, v, with_lse=True)
# cached blocks for every tensor the backward allocates, so that its thread
# makes no runtime call before the launcher's own
blocks = [torch.empty(1 << 15, device="cuda") for _ in range(32)]
del blocks
torch.cuda.synchronize()
got = {}
def body():
    got["grads"] = PA.flash_attention_bwd(q, k, v, out, dout, lse=lse)
t = threading.Thread(target=body)
t.start()
t.join()
ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
PA.flash_attention_fwd(*ins).backward(dout)
want = PA.flash_attention_bwd(q, k, v, out, dout, lse=lse)
torch.cuda.synchronize()
assert PA.FLASH_BWD_TC_KERNEL.launches == 3 * PA.BWD_PASSES["tensor_cores"]
assert all(torch.equal(a, w) for a, w in zip(got["grads"], want))
assert all(torch.equal(x.grad, w) for x, w in zip(ins, want))
print("ok")
"""


@pytest.mark.cuda
def test_tc_backward_first_on_autograds_thread_on_card(cuda_device):
    """In a fresh process, the tensor-core K4′ as the first CUDA work of a
    new thread and of autograd's device thread (its first pass encodes TMA
    maps, which needs a context current on that thread; the allocator is
    warmed so that nothing else binds one first): both run, on its route,
    bit for bit the direct call's."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    r = subprocess.run([sys.executable, "-c", _FIRST_BACKWARD], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
