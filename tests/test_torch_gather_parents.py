"""G3, the explicit-parents ancestry gather (ops/gather.py), against the
four TPU kernels it replaces, run in Pallas interpret mode on the CPU:
``fused_gather.gather_rows_clustered`` (row 6, and row 10 past 1022 rows),
``fused_gather.gather_transposed_clustered`` (row 10),
``sorted_gather.gather_rows_clustered`` (row 11) and
``gather.gather_rows_pallas`` (row 1). Only int32 values move, so the port
must be bit-equal. On CPU tensors the wrappers run their plain versions,
which are what these tests hold; the CUDA kernel is held against the same
plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from genparticlefilters_tpu.ops import fused_gather as jfg  # noqa: E402
from genparticlefilters_tpu.ops.gather import gather_rows_pallas  # noqa
from genparticlefilters_tpu.ops.sorted_gather import (  # noqa: E402
    gather_rows_clustered as sorted_rows_clustered)
from genparticlefilters_tpu_torch.ops import gather as g3  # noqa: E402
from genparticlefilters_tpu_torch.smc.resample import (  # noqa: E402
    _gather_traces)

EXTREMES = [0, -1, 2**31 - 1, -2**31, 12345, -12345, 65536, -65536]


def _ints(rng, shape):
    return rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(
        np.int32)


def _sorted_parents(rng, n, m):
    return np.sort(rng.integers(0, n, size=m)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x, order="C"))


@pytest.mark.parametrize("d,n,m", [(29, 2048, 700), (29, 512, 1536),
                                   (1025, 1024, 1024)])
def test_gather_cols_matches_lane_clustered_kernel(d, n, m):
    # row 6 (_kernel_clustered_lanes); d = 1025 takes row 10's route past
    # the 1022-row cap; M < N and M > N
    rng = np.random.default_rng(d + n + m)
    big = _ints(rng, (d, n))
    parents = _sorted_parents(rng, n, m)
    ref = np.asarray(jfg.gather_rows_clustered(
        jnp.asarray(big), jnp.asarray(parents), interpret=True))
    (out,) = g3.gather_cols([_t(big)], _t(parents))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("n,m,d", [(2048, 512, 72), (1000, 1000, 43)])
def test_gather_cols_matches_transposed_clustered_kernel(n, m, d):
    # row 10 (_kernel :1014): [N, D] in, [D, M] out — the port's pieces are
    # already particle-last, so G3's column mode is the same computation
    rng = np.random.default_rng(n + m + d)
    mat = _ints(rng, (n, d))
    parents = _sorted_parents(rng, n, m)
    ref = np.asarray(jfg.gather_transposed_clustered(
        jnp.asarray(mat), jnp.asarray(parents), interpret=True))
    (out,) = g3.gather_cols([_t(mat.T)], _t(parents))
    np.testing.assert_array_equal(out.numpy(), ref)
    (out_rows,) = g3.gather_rows([_t(mat)], _t(parents))
    np.testing.assert_array_equal(out_rows.numpy().T, ref)


def test_gather_rows_matches_sorted_clustered_kernel():
    # row 11 (sorted_gather._kernel): [N, D] rows, clustered parents
    n, d, m = 2048, 72, 512
    rng = np.random.default_rng(11)
    mat = _ints(rng, (n, d))
    parents = _sorted_parents(rng, n, m)
    ref = np.asarray(sorted_rows_clustered(jnp.asarray(mat),
                                           jnp.asarray(parents),
                                           interpret=True))
    (out,) = g3.gather_rows([_t(mat)], _t(parents))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_gather_rows_matches_dma_row_kernel_on_float_bits():
    # row 1 (gather._gather_kernel): arbitrary parents, float32 rows moved
    # as bit patterns
    n, d, m = 1024, 64, 256
    rng = np.random.default_rng(1)
    mat = rng.normal(size=(n, d)).astype(np.float32)
    mat[0, :4] = [np.nan, -0.0, np.inf, -np.inf]
    parents = rng.integers(0, n, size=m).astype(np.int32)
    parents[:3] = 0
    ref = np.asarray(gather_rows_pallas(jnp.asarray(mat),
                                        jnp.asarray(parents),
                                        interpret=True))
    (out,) = g3.gather_rows([_t(mat).view(torch.int32)], _t(parents))
    np.testing.assert_array_equal(out.view(torch.float32).numpy().view(
        np.int32), ref.view(np.int32))


ROW_WIDTHS = (1, 3, 4, 8, 12, 16)


def _offset_piece(rng, n, w, offset):
    """An [n, w] int32 piece that is a contiguous view ``offset`` values
    into its storage (a sub-state or sliced leaf): its address is not
    16-byte aligned unless ``offset`` is a multiple of 4."""
    flat = torch.from_numpy(_ints(rng, (offset + n * w,)))
    piece = flat[offset:].view(n, w)
    assert piece.is_contiguous() and piece.storage_offset() == offset
    return piece


@pytest.mark.parametrize("w", ROW_WIDTHS)
@pytest.mark.parametrize("offset", [0, 1])
def test_gather_rows_widths_match_row_kernels(w, offset):
    # row 1 (gather._gather_kernel) with arbitrary parents and row 11
    # (sorted_gather._kernel) with clustered parents, at the widths whose
    # unit the CUDA kernel picks by width and alignment; offset 1 is a view
    # whose address is 4 bytes past a 16-byte boundary (the scalar path)
    n, m = 1024, 256
    rng = np.random.default_rng(100 * w + offset)
    piece = _offset_piece(rng, n, w, offset)
    mat = piece.numpy()
    arbitrary = rng.integers(0, n, size=m).astype(np.int32)
    clustered = _sorted_parents(rng, n, m)
    refs = [(arbitrary, gather_rows_pallas(jnp.asarray(mat),
                                           jnp.asarray(arbitrary),
                                           interpret=True)),
            (clustered, sorted_rows_clustered(jnp.asarray(mat),
                                              jnp.asarray(clustered),
                                              interpret=True))]
    for parents, ref in refs:
        (out,) = g3.gather_rows([piece], _t(parents))
        assert out.shape == (m, w) and out.is_contiguous()
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,m", [(4096, 1024), (1024, 4096)])
def test_gather_rows_all_widths_in_one_call(n, m):
    # every width in one call, one piece a misaligned view; M = N/4, M = 4N
    rng = np.random.default_rng(n + 7 * m)
    pieces = [torch.from_numpy(_ints(rng, (n, w))) for w in ROW_WIDTHS]
    pieces.append(_offset_piece(rng, n, 8, 3))
    parents = rng.integers(0, n, size=m).astype(np.int32)
    outs = g3.gather_rows(pieces, _t(parents))
    for o, p in zip(outs, pieces):
        np.testing.assert_array_equal(o.numpy(), p.numpy()[parents])


@pytest.mark.parametrize("width,src,dst,want", [
    (8, 0, 0, 4), (4, 16, 4096, 4), (16, 1 << 20, 32, 4),  # 16-byte units
    (12, 48, 0, 4),
    (1, 0, 0, 1), (3, 0, 0, 1), (6, 0, 0, 1), (10, 16, 16, 1),  # widths
    (8, 4, 0, 1), (8, 0, 8, 1), (16, 12, 16, 1),  # addresses off 16 bytes
])
def test_row_mode_vector_width(width, src, dst, want):
    # the wrapper's per-piece unit: 4 int32 values (int4) only for a width
    # that is whole 16-byte units with both addresses 16-byte aligned
    assert g3._vector_width(width, src, dst) == want


def test_row_mode_vector_width_of_views():
    # a view's address carries its storage offset: a sub-state whose first
    # particle is not on a 16-byte boundary takes the scalar path
    base = torch.empty((64 * 8 + 4,), dtype=torch.int32)
    assert base.data_ptr() % 16 == 0      # a fresh allocation is aligned
    for offset, want in ((0, 4), (1, 1), (2, 1), (3, 1), (4, 4)):
        piece = base[offset:offset + 64 * 8].view(64, 8)
        assert g3._vector_width(8, piece.data_ptr(), 0) == want


def test_extreme_values_and_degenerate_parents():
    n, m = 256, 256
    vals = np.array([EXTREMES] * n, np.int32)          # [N, 8]
    rng = np.random.default_rng(2)
    parents = _sorted_parents(rng, n, m)
    ref = np.asarray(sorted_rows_clustered(jnp.asarray(vals),
                                           jnp.asarray(parents),
                                           interpret=True))
    (out,) = g3.gather_rows([_t(vals)], _t(parents))
    np.testing.assert_array_equal(out.numpy(), ref)
    (cols,) = g3.gather_cols([_t(vals.T)], _t(parents))
    np.testing.assert_array_equal(cols.numpy(), ref.T)
    # all parents on the last particle (fully degenerate resampling)
    n, m, d = 1024, 512, 32
    mat = _ints(rng, (n, d))
    last = np.full((m,), n - 1, np.int32)
    ref = np.asarray(jfg.gather_transposed_clustered(
        jnp.asarray(mat), jnp.asarray(last), interpret=True))
    (out,) = g3.gather_cols([_t(mat.T)], _t(last))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_arbitrary_permutation_and_several_pieces():
    # G3 takes any parents order (the block rotation/shuffle case)
    rng = np.random.default_rng(3)
    n = 3000
    perm = rng.permutation(n).astype(np.int32)
    pieces = [_ints(rng, (w, n)) for w in (1, 40, 7)]
    outs = g3.gather_cols([_t(p) for p in pieces], _t(perm))
    for o, p in zip(outs, pieces):
        np.testing.assert_array_equal(o.numpy(), p[:, perm])
    rows = [_ints(rng, (n, w)) for w in (8, 1)]
    outs = g3.gather_rows([_t(p) for p in rows], _t(perm[:1000]))
    for o, p in zip(outs, rows):
        np.testing.assert_array_equal(o.numpy(), p[perm[:1000]])


def test_wrappers_route_by_device():
    rng = np.random.default_rng(4)
    piece = _t(_ints(rng, (3, 50)))
    parents = _t(_sorted_parents(rng, 50, 20))
    before = (g3.gather_cols.launches, g3.gather_rows.launches)
    (out,) = g3.gather_cols([piece], parents)
    assert torch.equal(out, g3.gather_cols_plain([piece], parents)[0])
    (out,) = g3.gather_rows([piece.T.contiguous()], parents)
    assert torch.equal(out, g3.gather_rows_plain([piece.T.contiguous()],
                                                 parents)[0])
    # CPU tensors never count as kernel launches
    assert (g3.gather_cols.launches, g3.gather_rows.launches) == before
    assert g3.gather_cols([], parents) == []
    meta = torch.empty((20,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        g3.gather_cols([torch.empty((3, 50), dtype=torch.int32,
                                    device="meta")], meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        g3.gather_rows([torch.empty((50, 3), dtype=torch.int32,
                                    device="meta")], meta)
    with pytest.raises(ValueError, match="int32"):
        g3.gather_cols([piece.float()], parents)
    with pytest.raises(ValueError, match="parents"):
        g3.gather_cols([piece], parents.long())
    with pytest.raises(ValueError, match="particle count"):
        g3.gather_cols([piece, _t(_ints(rng, (2, 49)))], parents)


def test_gather_traces_routes_every_leaf():
    # the state-level gather: particle-last pieces by column mode,
    # contiguous particle-first leaves of rank >= 2 by row mode (no
    # transposing copy), other dtypes by index_select; bit patterns kept
    rng = np.random.default_rng(5)
    n = 300
    tree = {"f": torch.from_numpy(rng.normal(size=(n, 3)).astype(
                np.float32)),
            "i": torch.from_numpy(_ints(rng, (n,))),
            "b": torch.from_numpy(rng.random((n, 2)) < 0.5),
            "t": torch.from_numpy(_ints(rng, (4, n))).T,   # not contiguous
            "d": torch.from_numpy(rng.normal(size=(n,)))}  # float64
    tree["f"][0, 0] = -0.0
    parents = _t(rng.permutation(n)[:200].astype(np.int32))
    out = _gather_traces(tree, parents)
    idx = parents.long()
    for k in ("f", "i", "b", "d", "t"):
        ref = torch.index_select(tree[k], 0, idx)
        assert out[k].dtype == ref.dtype and torch.equal(
            out[k].view(torch.int32) if k == "f" else out[k],
            ref.view(torch.int32) if k == "f" else ref), k
