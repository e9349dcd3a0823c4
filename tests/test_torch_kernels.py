"""The port's kernel modules against the JAX reference, on the CPU.

K1 and K2 (``repro_torch/kernels/pg/pg.py``, with K2's round
``kernels/pg/ops.py::pg_argmax``) and K3
(``repro_torch/kernels/resize/resize.py``) run here through their plain
PyTorch versions — a CUDA kernel has no host mode — and those are held
against the Pallas kernels (interpret mode, as ``tests/test_kernels_pg.py``
and ``tests/test_kernels_resize.py`` run them) and their jnp oracles. The
primal gradient is held BITWISE against the reference run eagerly
(``jax.disable_jit()``): under ``jit`` XLA contracts its sums into FMAs and
moves an ulp. ``tests/test_torch_cuda.py`` holds each CUDA kernel against
its plain version on a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import greedy as JG  # noqa: E402
from repro.kernels.pg import ops as j_pg_ops  # noqa: E402
from repro.kernels.pg import pg as JK  # noqa: E402
from repro.kernels.pg.ref import batch_round_ref as j_round_ref  # noqa: E402
from repro.kernels.pg.ref import masked_argmax_ref as j_argmax_ref  # noqa: E402
from repro.kernels.resize import ops as j_ops  # noqa: E402
from repro.kernels.resize import ref as j_rref  # noqa: E402

from repro_torch.core import greedy as G  # noqa: E402
from repro_torch.kernels.pg import ops as p_pg_ops  # noqa: E402
from repro_torch.kernels.pg import pg as PK  # noqa: E402
from repro_torch.kernels.resize import ops as p_ops  # noqa: E402
from repro_torch.kernels.resize import resize as PR  # noqa: E402


def _random_round(rng, b, t, a, m, occupied_frac=0.5):
    """The input draw of ``tests/test_kernels_pg.py``, as numpy."""
    grid = rng.uniform(1, 10, (a, m)).astype(np.float32)
    price = rng.uniform(0.1, 1, (b, m)).astype(np.float32)
    cap = rng.uniform(20, 40, (b, m)).astype(np.float32)
    occ = (rng.uniform(0, 5, (b, m))
           * (rng.random((b, m)) < occupied_frac)).astype(np.float32)
    lat = rng.random((b, t, a)) < 0.3
    alive = rng.random((b, t)) < 0.7
    return lat, alive, grid, price, cap, occ


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _eager_round(lat, alive, grid, price, cap, occ):
    """The round's (V, tau, best_a) from the reference's primal gradient run
    eagerly, instance by instance, with exact numpy masking and first-max
    selection (a max and an argmax round nothing)."""
    with jax.disable_jit():
        pg = np.stack([np.asarray(JG.primal_gradient(
            jnp.asarray(grid), jnp.asarray(price[b]), jnp.asarray(cap[b]),
            jnp.asarray(occ[b]), xp=jnp)) for b in range(len(price))])
    lim = (cap - occ) + np.float32(1e-9)
    cap_ok = (grid[None] <= lim[:, None, :]).all(-1)
    score = np.where(lat & cap_ok[:, None, :] & alive[:, :, None],
                     pg[:, None, :], -np.inf).astype(np.float32)
    row = score.max(2)
    tau = row.argmax(1)
    return row.max(1), tau, score[np.arange(len(tau)), tau].argmax(1)


def _check_round(lat, alive, grid, price, cap, occ):
    """Every plain version of K1 against the reference: V bitwise against
    the eager reference gradient, (tau, best_a) equal to the Pallas kernel
    and the jitted dense oracle; the bit-domain torch round's decisions
    equal to the reference's jnp round."""
    v0, tau0, a0 = _eager_round(lat, alive, grid, price, cap, occ)
    j = [jnp.asarray(x) for x in (lat, alive, grid, price, cap, occ)]
    for out in (j_round_ref(*j),
                JK.batch_round(JG._pack_bits(j[0]), *j[1:], block_t=8)):
        v1, tau1, a1 = (np.asarray(x) for x in out)
        assert (tau1 == tau0).all() and (a1 == a0).all()
        assert np.allclose(v1, v0, rtol=1e-6)

    p = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (lat, alive, grid, price, cap, occ)]
    words = G._pack_bits(p[0])
    for out in (PK.batch_round_ref(*p), PK.batch_round(words, *p[1:])):
        v, tau, best_a = (x.numpy() for x in out)
        assert (_bits(v) == _bits(v0)).all()
        assert (tau == tau0).all() and (best_a == a0).all()

    a = grid.shape[0]
    jr = jax.jit(JG._flex_round_fn("jnp", JG._pack_bits(j[0]), j[2], j[3],
                                   j[4], a))
    jv, jt, ja = (np.asarray(x) for x in jr(j[5], j[1]))
    tv, tt, ta = (x.numpy() for x in G._flex_round_fn(
        words, p[2], p[3], p[4], a)(p[5], p[1]))
    assert (_bits(tv) == _bits(v0)).all()
    assert (tt == jt).all() and (ta == ja).all()


@pytest.mark.parametrize("b,t,a,m", [(1, 1, 1, 2), (3, 7, 33, 2),
                                     (5, 37, 97, 2), (4, 26, 129, 4)])
def test_round_plain_versions_match_reference(b, t, a, m, rng):
    _check_round(*_random_round(rng, b, t, a, m))


def test_round_uniform_branch(rng):
    """occupied == 0 exercises the uniform-penalty PG branch (Alg. 1 l.23)."""
    _check_round(*_random_round(rng, 4, 20, 65, 2, occupied_frac=0.0))


def test_round_ties_first_max(rng):
    """price = 0 makes every gradient 0: the all-tie selection must follow
    the first-max order across tasks and lanes."""
    lat, alive, grid, _, cap, occ = _random_round(rng, 4, 33, 70, 2)
    _check_round(lat, alive, grid, np.zeros((4, 2), np.float32), cap,
                 np.zeros_like(occ))


def test_round_all_infeasible(rng):
    lat = np.zeros((3, 9, 40), bool)
    alive = np.ones((3, 9), bool)
    grid = rng.uniform(1, 5, (40, 2)).astype(np.float32)
    pool = np.full((3, 2), 10.0, np.float32)
    _check_round(lat, alive, grid, pool / 10, pool, np.zeros((3, 2),
                                                             np.float32))
    v, tau, best_a = PK.batch_round(
        G._pack_bits(torch.from_numpy(lat)), torch.from_numpy(alive),
        torch.from_numpy(grid), torch.from_numpy(pool / 10),
        torch.from_numpy(pool), torch.zeros(3, 2))
    assert torch.isneginf(v).all()
    assert (tau == 0).all() and (best_a == 0).all()


@pytest.mark.parametrize("m", [2, 4])
def test_primal_gradient_bitwise_eager_reference(m):
    """The port's f32 gradient is the plain formula in the eager order, bit
    for bit, on both branches, with zero prices (signed-zero sums) too."""
    rng = np.random.default_rng(m)
    A, B = 300, 24
    grid = rng.uniform(0.5, 20, (A, m)).astype(np.float32)
    price = rng.uniform(0.01, 1, (B, m)).astype(np.float32)
    price[:4] = 0.0
    cap = rng.uniform(5, 40, (B, m)).astype(np.float32)
    occ = (rng.uniform(0, 10, (B, m))
           * (rng.random((B, m)) < 0.6)).astype(np.float32)
    occ[::5] = 0.0
    with jax.disable_jit():
        ref = np.stack([np.asarray(JG.primal_gradient(
            jnp.asarray(grid), jnp.asarray(price[b]), jnp.asarray(cap[b]),
            jnp.asarray(occ[b]), xp=jnp)) for b in range(B)])
    t = [torch.from_numpy(x) for x in (grid, price, cap, occ)]
    out = G._batch_pg(*t).numpy()
    assert (_bits(out) == _bits(ref)).all()
    one = G.primal_gradient(t[0], t[1][7], t[2][7], t[3][7]).numpy()
    assert (_bits(one) == _bits(ref[7])).all()
    # the numpy path is the oracle's, value for value
    g64 = grid.astype(np.float64)
    assert np.array_equal(
        G.primal_gradient(g64, price[7] * 1.0, cap[7] * 1.0, occ[7] * 1.0),
        JG.primal_gradient(g64, price[7] * 1.0, cap[7] * 1.0, occ[7] * 1.0))


def test_pack_bits_layout_matches_reference(rng):
    for a in (1, 31, 32, 33, 300):
        mask = rng.random((3, 5, a)) < 0.5
        ref = np.asarray(JG._pack_bits(jnp.asarray(mask)))
        out = G._pack_bits(torch.from_numpy(mask)).numpy()
        assert out.dtype == np.int32
        assert np.array_equal(out.view(np.uint32), ref)
        assert np.array_equal(G._unpack_bits(torch.from_numpy(out), a)
                              .numpy(), mask)


def test_kernel_inner_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        G.resolve_inner("kernel", "cpu")
    assert G.resolve_inner(None, "cpu") == "torch"
    assert G.resolve_inner(None, "cuda") == "kernel"
    from repro_torch.core import TaskSet, build_instance, scenarios
    inst = build_instance(scenarios.numerical_pool(2), TaskSet(
        app_idx=np.array([0, 5]), min_accuracy=np.array([0.2, 0.35]),
        max_latency=np.array([0.7, 0.7]), bits_per_job=np.array([0.8, 0.8]),
        jobs_per_sec=np.array([5.0, 5.0]),
        gpu_time_per_job=np.array([0.125, 0.042]), n_ues=np.array([1, 1])))
    with pytest.raises(ValueError, match="CUDA"):
        G.solve_greedy_batch([inst], inner="kernel", device="cpu")
    assert G.solve_greedy_batch([inst], device="cpu")[0].admitted.all()
    with pytest.raises(ValueError, match="CUDA"):
        G.solve_greedy_torch(inst, inner="kernel", device="cpu")
    assert G.solve_greedy_torch(inst, device="cpu").admitted.all()


# ------------------------------------------------------------------- K2

def _argmax_inputs(rng, t, a):
    """K2 inputs with planted ties (sel drawn from 8 values, so rows share
    maxima at several lanes), all-masked rows and dead rows."""
    sel = rng.integers(-4, 4, a).astype(np.float32) * 0.25
    lat = rng.random((t, a)) < 0.35
    lat[::5] = False                                  # nothing feasible
    cap = rng.random(a) < 0.7
    alive = rng.random(t) < 0.8
    alive[1::7] = False                               # dead rows
    return sel, lat, cap, alive


def _check_argmax(sel, lat, cap, alive):
    """The plain K2 against the reference's oracle and its Pallas kernel
    (interpret mode, blocks that do not divide T or A): equal, with -inf
    and index 0 on rows with nothing feasible."""
    j = [jnp.asarray(x) for x in (sel, lat, cap, alive)]
    g0, i0 = (np.asarray(x) for x in j_argmax_ref(*j))
    g1, i1 = (np.asarray(x) for x in JK.masked_argmax(
        *j, block_t=8, block_a=128, interpret=True))
    assert np.array_equal(g0, g1) and np.array_equal(i0, i1)
    p = [torch.from_numpy(np.ascontiguousarray(x)) for x in (sel, lat, cap,
                                                              alive)]
    for out in (PK.masked_argmax(*p), PK.masked_argmax_ref(*p),
                PK.masked_argmax(p[0], *(x.to(torch.uint8) for x in p[1:]))):
        g, i = (x.numpy() for x in out)
        assert g.dtype == np.float32 and i.dtype == np.int32
        assert np.array_equal(g, g0) and np.array_equal(i, i0)
    none = ~(lat & cap[None, :] & alive[:, None]).any(1)
    assert np.isneginf(g0[none]).all() and (i0[none] == 0).all()


@pytest.mark.parametrize("t,a", [(1, 1), (3, 7), (17, 129), (37, 300),
                                 (50, 1280)])
def test_masked_argmax_plain_matches_reference(t, a, rng):
    _check_argmax(*_argmax_inputs(rng, t, a))


def test_masked_argmax_all_false_cap_and_all_ties(rng):
    sel, lat, cap, alive = _argmax_inputs(rng, 13, 77)
    _check_argmax(sel, lat, np.zeros_like(cap), alive)
    _check_argmax(np.zeros_like(sel), lat, cap, alive)


def test_masked_argmax_checks_its_inputs():
    sel = torch.zeros(4)
    ok = torch.ones(3, 4, dtype=torch.bool)
    with pytest.raises(TypeError, match="sel"):
        PK.masked_argmax(sel.double(), ok, ok[0], ok[:, 0])
    with pytest.raises(TypeError, match="cap_ok"):
        PK.masked_argmax(sel, ok, ok[0, :3], ok[:, 0])
    with pytest.raises(TypeError, match="alive"):
        PK.masked_argmax(sel, ok, ok[0], ok[:, 0].float())
    with pytest.raises(ValueError, match="allocation"):
        PK.masked_argmax(torch.zeros(0), ok[:, :0], ok[0, :0], ok[:, 0])


@pytest.mark.parametrize("flexible", [True, False])
@pytest.mark.parametrize("occupied_frac", [0.0, 0.6])
def test_pg_argmax_matches_reference(flexible, occupied_frac, rng):
    """K2's round: the reference's ``pg_argmax`` run eagerly around its
    Pallas kernel (interpret mode) against the port's over the plain K2 and
    the port's ``_inner_torch``: G bitwise, best_a and has equal."""
    a, t, m = 150, 23, 2
    grid = rng.integers(1, 10, (a, m)).astype(np.float32)
    price = rng.uniform(0.05, 0.2, m).astype(np.float32)
    cap = rng.integers(10, 30, m).astype(np.float32)
    occ = np.floor(cap * occupied_frac * rng.random(m)).astype(np.float32)
    lat = rng.random((t, a)) < 0.3
    lat[4] = False
    alive = rng.random(t) < 0.8
    cost = (grid * np.array([1.0, 1000.0], np.float32)).sum(1)
    args = (grid, price, cap, occ, cap - occ, lat, alive, cost)
    with jax.disable_jit():
        jG, ja, jh = (np.asarray(x) for x in j_pg_ops.pg_argmax(
            *(jnp.asarray(x) for x in args), flexible=flexible,
            interpret=True, block_t=8, block_a=128))
    targs = [torch.from_numpy(np.ascontiguousarray(x)) for x in args]
    for out in (p_pg_ops.pg_argmax(*targs, flexible=flexible),
                G._inner_torch(*targs, flexible=flexible)):
        pG, pa, ph = (x.numpy() for x in out)
        assert (_bits(pG) == _bits(jG)).all()
        assert np.array_equal(pa, ja) and np.array_equal(ph, jh)
    assert jh.any() and not jh.all()


# ------------------------------------------------------------------- K3

@pytest.mark.parametrize("b,h,w,c", [(1, 8, 8, 1), (2, 32, 48, 3),
                                     (3, 17, 31, 4), (1, 64, 64, 2)])
@pytest.mark.parametrize("z", [1.0, 0.5, 0.25, 0.04])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_plain_version_matches_reference(b, h, w, c, z, dtype, rng):
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    jimg = jnp.asarray(x, getattr(jnp, dtype))
    timg = torch.from_numpy(x).to(getattr(torch, dtype))
    ho, wo = j_rref.out_size_for_z(h, w, z)
    ref = np.asarray(j_rref.resize_ref(jimg, j_rref.resize_matrix(ho, h),
                                       j_rref.resize_matrix(wo, w)),
                     np.float32)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for use_kernel in (True, False):
        out = p_ops.compress_frames(timg, z, use_kernel=use_kernel)
        assert out.dtype == timg.dtype and out.shape == ref.shape
        assert np.allclose(out.float().numpy(), ref, rtol=tol, atol=tol)
    if dtype == "float32":
        pallas = np.asarray(j_ops.compress_frames(jimg, z, use_kernel=True))
        assert np.allclose(out.numpy(), pallas, rtol=tol, atol=tol)
    if z == 1.0:
        assert np.allclose(out.float().numpy(), timg.float().numpy(),
                           atol=1e-6)


def test_resize_taps_rebuild_the_reference_matrices():
    """``resize_taps`` — the taps K3 derives in its kernel — rebuild the
    reference's interpolation matrices exactly (two taps per row, the high
    one folded into the low at the clamped edge)."""
    for n_out, n_in in ((1, 1), (16, 8), (8, 8), (3, 17), (26, 128),
                        (205, 1024), (1, 640)):
        R = j_rref.resize_matrix(n_out, n_in)
        assert np.array_equal(PR.resize_matrix(n_out, n_in), R)
        idx, wt = PR.resize_taps(n_out, n_in)
        rebuilt = np.zeros_like(R)
        rows = np.arange(n_out)
        np.add.at(rebuilt, (rows, idx[0]), wt[0])
        np.add.at(rebuilt, (rows, idx[1]), wt[1])
        assert np.array_equal(rebuilt, R)
    for h, w, z in ((128, 128, 0.04), (640, 640, 0.25), (1024, 2048, 0.5)):
        assert PR.out_size_for_z(h, w, z) == j_rref.out_size_for_z(h, w, z)


def _kernel_taps(n_out, n_in):
    """A float64 torch model of ``csrc/resize.cu::tap``, operation for
    operation: scale, the half-pixel source clamped to [0, n_in - 1], floor,
    the two weights rounded to float32, the clamped edge folded."""
    f64 = torch.float64
    scale = torch.tensor(float(n_in), dtype=f64) / torch.tensor(
        float(n_out), dtype=f64)
    src = (torch.arange(n_out, dtype=f64) + 0.5) * scale + (-0.5)
    src = torch.minimum(torch.maximum(src, torch.tensor(0.0, dtype=f64)),
                        torch.tensor(float(n_in - 1), dtype=f64))
    lo = torch.floor(src)
    frac = src + (-lo)
    w_lo = (1.0 + (-frac)).to(torch.float32)
    w_hi = frac.to(torch.float32)
    lo = lo.to(torch.int32)
    edge = lo + 1 >= n_in
    hi = torch.where(edge, lo, lo + 1)
    w_lo = torch.where(edge, w_lo + w_hi, w_lo)
    w_hi = torch.where(edge, torch.zeros_like(w_hi), w_hi)
    return torch.stack([lo, hi]).numpy(), torch.stack([w_lo, w_hi]).numpy()


@pytest.mark.parametrize("n_in", [128, 1024, 2048])
def test_kernel_tap_arithmetic_equals_resize_taps(n_in):
    """K3 derives its taps in the kernel: that float64 arithmetic gives
    ``resize_taps`` bit for bit at every compression of ``chip_smoke.py``'s
    phase 4, a sweep of z, the serving range's sizes and upsampling."""
    zs = [0.04, 0.25, 0.5, 1.0] + list(np.linspace(0.01, 1.0, 67)) \
        + [0.02 * k for k in range(1, 8)]
    sizes = {PR.out_size_for_z(n_in, n_in, z)[0] for z in zs}
    sizes |= {1, 2, 3, n_in - 1, n_in + 1, 2 * n_in + 3}
    for n_out in sorted(sizes):
        idx, wt = PR.resize_taps(n_out, n_in)
        kidx, kwt = _kernel_taps(n_out, n_in)
        assert np.array_equal(kidx, idx), n_out
        assert np.array_equal(kwt.view(np.int32), wt.view(np.int32)), n_out


@pytest.mark.parametrize("b,h,w,c,ho,wo", [(2, 32, 48, 3, 7, 10),
                                           (3, 17, 31, 4, 17, 31),
                                           (1, 64, 64, 2, 13, 13),
                                           (2, 20, 12, 3, 41, 5)])
def test_resize_plain_version_with_sizes_matches_pallas(b, h, w, c, ho, wo,
                                                        rng):
    """K3's plain version, called with the output size, against the
    Pallas kernel in interpret mode on the reference's ``resize_matrix``
    inputs: within 1e-5 (sums in another order)."""
    from repro.kernels.resize import resize as j_resize
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    pallas = np.asarray(j_resize.resize_bilinear(
        jnp.asarray(x), jnp.asarray(j_rref.resize_matrix(ho, h)),
        jnp.asarray(j_rref.resize_matrix(wo, w)), interpret=True))
    out = PR.resize_bilinear(torch.from_numpy(x), ho, wo)
    assert out.shape == (b, ho, wo, c) and out.dtype == torch.float32
    assert np.allclose(out.numpy(), pallas, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, PR.resize_bilinear_ref(torch.from_numpy(x), ho,
                                                   wo))
