"""The port's kernel modules against the JAX reference, on the CPU.

K1 (``repro_torch/kernels/pg/pg.py``) and K3
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
from repro.kernels.pg import pg as JK  # noqa: E402
from repro.kernels.pg.ref import batch_round_ref as j_round_ref  # noqa: E402
from repro.kernels.resize import ops as j_ops  # noqa: E402
from repro.kernels.resize import ref as j_rref  # noqa: E402

from repro_torch.core import greedy as G  # noqa: E402
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
        "torch", words, p[2], p[3], p[4], a)(p[5], p[1]))
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
    for n_out, n_in in ((1, 1), (16, 8), (8, 8), (3, 17), (26, 128),
                        (205, 1024), (1, 640)):
        R = j_rref.resize_matrix(n_out, n_in)
        assert np.array_equal(PR.resize_matrix(n_out, n_in), R)
        taps = PR.device_taps(n_out, n_in, "cpu")
        assert np.array_equal(PR.matrix_from_taps(taps, n_in).numpy(), R)
    for h, w, z in ((128, 128, 0.04), (640, 640, 0.25), (1024, 2048, 0.5)):
        assert PR.out_size_for_z(h, w, z) == j_rref.out_size_for_z(h, w, z)
