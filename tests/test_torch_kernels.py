"""The kernels' plain versions against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the plain version, because their
tensors lie on the CPU; the CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.  Here the plain
versions are held against ``logistic_vjp_pallas`` / ``svm_vjp_pallas`` /
``soft_threshold_pallas`` in interpret mode and against the JAX wrappers
under ``REPRO_PALLAS=interpret``, on ragged shapes and zero-mask lanes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import logistic_vjp as j_lv                # noqa: E402
from repro.kernels import ops as j_ops                        # noqa: E402
from repro.kernels import soft_threshold as j_st              # noqa: E402
from repro_torch.device import resolve_device                 # noqa: E402
from repro_torch.kernels import logistic_vjp as t_lv          # noqa: E402
from repro_torch.kernels import ops as t_ops                  # noqa: E402
from repro_torch.kernels import ref as t_ref                  # noqa: E402
from repro_torch.kernels import soft_threshold as t_st        # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _margin_inputs(seed, W, N, D, zero_lanes=()):
    rng = np.random.RandomState(seed)
    A = (rng.randn(W, N, D) * 0.3).astype(np.float32)
    b = np.sign(rng.randn(W, N)).astype(np.float32)
    mask = (rng.rand(W, N) < 0.8).astype(np.float32)
    mask[list(zero_lanes)] = 0.0
    x = (rng.randn(W, D) * 0.2).astype(np.float32)
    return A, b, mask, x


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("loss,gamma", [("logistic", 0.0), ("hinge", 0.5),
                                        ("hinge", 0.2)])
def test_plain_margin_matches_pallas_interpret(loss, gamma):
    """One lane on the kernel's own aligned shapes (N % 256, D % 128)."""
    A, b, mask, x = _margin_inputs(0, 1, 512, 256)
    args = (jnp.asarray(A[0]), jnp.asarray(b[0][:, None]),
            jnp.asarray(mask[0][:, None]), jnp.asarray(x))
    if loss == "logistic":
        lj, gj = j_lv.logistic_vjp_pallas(*args, interpret=True)
        lt, gt = t_ref.logistic_vjp_ref(*_t(A, b, mask, x))
    else:
        lj, gj = j_lv.svm_vjp_pallas(*args, gamma=gamma, interpret=True)
        lt, gt = t_ref.svm_vjp_ref(*_t(A, b, mask, x), gamma)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj)[:, 0], **TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)


@pytest.mark.parametrize("loss", ["logistic", "hinge"])
@pytest.mark.parametrize("W,N,D", [(3, 111, 70), (2, 300, 129),
                                   (16, 8, 24), (1, 1, 5)])
def test_ops_match_jax_wrappers_ragged(monkeypatch, loss, W, N, D):
    """Ragged N and D, one all-zero-mask lane: the port's ops (plain on
    the CPU, launch counters untouched) against the JAX ops in interpret
    mode, which pads to the kernel's tiles."""
    monkeypatch.setenv("REPRO_PALLAS", "interpret")
    A, b, mask, x = _margin_inputs(W + N + D, W, N, D, zero_lanes=(0,))
    t_lv.reset_launches()
    if loss == "logistic":
        lj, gj = j_ops.fused_logistic_vjp(jnp.asarray(A), jnp.asarray(b),
                                          jnp.asarray(x),
                                          mask=jnp.asarray(mask))
        lt, gt = t_ops.fused_logistic_vjp(*_t(A, b, x), mask=_t(mask)[0])
    else:
        lj, gj = j_ops.fused_svm_vjp(jnp.asarray(A), jnp.asarray(b),
                                     jnp.asarray(x), gamma=0.3,
                                     mask=jnp.asarray(mask))
        lt, gt = t_ops.fused_svm_vjp(*_t(A, b, x), gamma=0.3,
                                     mask=_t(mask)[0])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)
    # the all-zero-mask lane gives exactly 0
    assert float(lt[0]) == 0.0 and not torch.any(gt[0])
    assert t_lv.LAUNCHES == {"logistic": 0, "hinge": 0}


def test_ops_unbatched_form_and_default_mask():
    A, b, _, x = _margin_inputs(5, 1, 40, 12)
    f1, g1 = t_ops.fused_logistic_vjp(*_t(A[0], b[0], x[0]))
    fW, gW = t_ops.fused_logistic_vjp(*_t(A, b, x))
    assert f1.shape == () and g1.shape == (12,)
    assert torch.equal(f1, fW[0]) and torch.equal(g1, gW[0])


@pytest.mark.parametrize("d", [128, 1024, 8320])
def test_plain_z_update_matches_pallas_interpret(d):
    rng = np.random.RandomState(d)
    omega = rng.randn(d).astype(np.float32)
    z_old = rng.randn(d).astype(np.float32)
    zj, sj, nj = j_st.soft_threshold_pallas(
        jnp.asarray(omega[None]), jnp.asarray(z_old[None]),
        jnp.asarray([[0.37]], jnp.float32), interpret=True)
    zt, st, nt = t_ref.soft_threshold_ref(*_t(omega, z_old),
                                          torch.tensor(0.37))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj)[0])
    np.testing.assert_allclose(float(st), float(sj[0, 0]), rtol=1e-5)
    assert int(nt) == int(nj[0, 0])


@pytest.mark.parametrize("d", [1, 70, 10_000])
def test_fused_z_update_matches_jax_wrapper(monkeypatch, d):
    """Ragged D through both wrappers (JAX pads to 128); nnz is an exact
    integer count on the port's side."""
    monkeypatch.setenv("REPRO_PALLAS", "interpret")
    rng = np.random.RandomState(d)
    omega = rng.randn(d).astype(np.float32)
    z_old = rng.randn(d).astype(np.float32)
    thr = 0.7 / 3.0
    zj, sj, nj = j_ops.fused_z_update(jnp.asarray(omega), jnp.asarray(z_old),
                                      thr)
    t_st.reset_launches()
    zt, st, nt = t_ops.fused_z_update(*_t(omega, z_old), thr)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
    assert nt.dtype == torch.int64 and int(nt) == int(nj)
    assert t_st.LAUNCHES == {"soft_threshold": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: there is no CPU path
    inside the kernel wrappers themselves."""
    A, b, mask, x = _t(*_margin_inputs(1, 2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        t_lv.margin_vjp_cuda(A, b, mask, x, loss="logistic")
    with pytest.raises(ValueError, match="CUDA"):
        t_st.soft_threshold_cuda(x[0], x[1], 0.1)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("W,N,D,sms,want", [
    (64, 9375, 10_000, 132, (132, 1, 512, 5)),   # the paper instance
    (1024, 8, 128, 132, (132, 1, 32, 1)),        # ranges cross many lanes
    (1, 2048, 128, 132, (132, 1, 32, 1)),        # one lane
    (3, 111, 70, 132, (132, 1, 32, 1)),          # ragged rows and columns
    (2, 300, 40_000, 132, (33, 4, 512, 5)),      # a cluster of 4 blocks
    (1, 1, 5, 132, (1, 1, 32, 1)),               # fewer rows than SMs
    (2, 50, 20_001, 132, (33, 4, 512, 3)),       # cp.async rows, a cluster
    (2, 10, t_lv.max_d(True) + 4, 132, None),    # above the cluster limit
    (2, 10, t_lv.max_d(False) + 1, 132, None),   # the same, cp.async rows
])
def test_margin_plan(W, N, D, sms, want):
    """The one-pass margin kernel's launch: every (lane, row) in exactly
    one range, ranges within one row of each other, each lane's partials
    summed in the order its ranges touch it (distinct scratch slots
    g + w), and the columns held by T * K * 4 * C >= D."""
    if want is None:
        with pytest.raises(ValueError,
                           match=str(t_lv.max_d(D % 4 == 0))):
            t_lv.plan(W, N, D, sms)
        return
    p = t_lv.plan(W, N, D, sms)
    assert (p.groups, p.cluster, p.threads, p.chunks) == want
    ranges = p.ranges()
    assert len(ranges) == p.groups and ranges[0][0] == 0
    assert ranges[-1][1] == W * N
    assert all(e == s for (_, e), (s, _) in zip(ranges, ranges[1:]))
    lengths = {e - s for s, e in ranges}
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    slots = set()
    for w in range(W):
        touch = p.touchers(w)
        # the lane's rows, walked in order, meet its ranges in combine order
        met = []
        for r in range(w * N, (w + 1) * N, max(1, N // 64)):
            g = next(g for g, (s, e) in enumerate(ranges) if s <= r < e)
            if not met or met[-1] != g:
                met.append(g)
        assert touch[0] == met[0] and touch == sorted(touch)
        assert touch == list(range(touch[0], touch[-1] + 1))
        slots.update(g + w for g in touch)
    n_pairs = sum(len(p.touchers(w)) for w in range(W))
    assert len(slots) == n_pairs and max(slots) < p.scratch_slots
    assert p.threads * p.chunks * 4 * p.cluster >= D
    assert p.threads * p.chunks * 4 >= p.cols
    assert p.cluster == 1 or p.cols % 4 == 0     # whole float4 chunks
    assert D - (p.cluster - 1) * p.cols > 0          # every block has columns
    assert p.threads % 32 == 0 and p.threads <= t_lv.MAX_THREADS
    assert p.bulk == (D % 4 == 0)
    assert 1 <= p.chunks <= t_lv.MAX_CHUNKS[p.bulk]
    assert 2 <= p.stages <= t_lv.MAX_STAGES
    assert p.smem_bytes <= t_lv.RING_BYTES


@pytest.mark.parametrize("D,want", [(1, 1), (70, 1), (10_000, 10),
                                    (1_000_003, 132), (346_030_080, 132),
                                    (2 ** 31 - 132 * 256, 132)])
def test_z_update_plan(D, want):
    """One block per 4 * 256 elements, at most one per SM; the block
    partials fit the scratch the wrapper allocates; granite_moe's stacked
    expert leaf at 11 layers, (11, 40, 1536, 512), and the largest length
    whose int32 indices the grid's stride cannot overflow."""
    blocks = t_st.plan(D, 132)
    assert blocks == want
    assert 1 <= blocks <= 132
    assert blocks == 1 or (blocks - 1) * 4 * t_st.THREADS < D


def test_z_update_plan_refuses_what_int32_cannot_index():
    with pytest.raises(ValueError, match="int32"):
        t_st.plan(2 ** 31 - 132 * 256 + 1, 132)


def _ptxas_entry(mangled, spill_bytes):
    return (f"ptxas info    : Compiling entry function '{mangled}' for "
            f"'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    0 bytes stack frame, {spill_bytes} bytes spill stores, "
            f"{spill_bytes} bytes spill loads\n"
            f"ptxas info    : Used 128 registers, 400 bytes cmem[0]\n")


_MARGIN_5 = "_ZN12_GLOBAL__N_115margin_one_passILi5ELb1EEEvNS_6ParamsE"
_MARGIN_4 = "_ZN12_GLOBAL__N_115margin_one_passILi4ELb0EEEvNS_6ParamsE"
_OTHER = "_ZN12_GLOBAL__N_121soft_threshold_blocksILb1EEEvPKfS2_fPfS3_PiS4_i"


@pytest.mark.parametrize("log,passes", [
    (_ptxas_entry(_MARGIN_5, 0) + _ptxas_entry(_MARGIN_4, 0), True),
    (_ptxas_entry(_MARGIN_5, 0) + _ptxas_entry(_MARGIN_4, 8), False),
    ("", False),
    (_ptxas_entry(_OTHER, 0), False),
], ids=["clean", "spill", "no_log", "no_margin_body"])
def test_chip_smoke_margin_spill_check(log, passes):
    """Phase 1's gate passes only on a report that names margin bodies,
    none of which spills: a missing or foreign report is no evidence."""
    from test_torch_attention import _chip_smoke
    smoke = _chip_smoke()
    if passes:
        smoke.check_margin_spills(log)
    else:
        with pytest.raises(SystemExit):
            smoke.check_margin_spills(log)
