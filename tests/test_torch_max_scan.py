"""G5, the running maximum (genparticlefilters_tpu_torch/ops/max_scan.py).

On the CPU: the wrapper's refusals, the plain route against a serial
transcription of torch.cummax's rule (a NaN sticks and a later NaN's bits
replace it; on a tie, +0.0 against -0.0 included, the later element
wins), the kernel's tiling (``_plan``) and its chained fold of tiles
transcribed in plain PyTorch, and every former ``torch.cummax`` call site
of the resample and resize verbs going through ``max_scan`` with its
result unchanged.

Marked ``chip``, on the card (these tests import no JAX: run them there
with ``python -m pytest --noconftest tests/test_torch_max_scan.py``): the
kernel bit-equal to ``torch.cummax(...).values`` for int32 and float32
at lengths around every tile and at [K, b] shapes, on planted one-ulp
dips, NaN, signed zeros, constant and descending input; captured in a
CUDA graph and replayed 50 times with new input; and the captured 1M
residual and 100K systematic object-motion filters bit-equal to the same
filters captured with ``torch.cummax`` in its place.
"""

import importlib
import math
import re
from pathlib import Path

import pytest
import torch

import genparticlefilters_tpu_torch as tg
from genparticlefilters_tpu_torch.core.tree import tree_leaves
from genparticlefilters_tpu_torch.ops.max_scan import (max_scan,
                                                       max_scan_plain)
from genparticlefilters_tpu_torch.smc import resample as R
from genparticlefilters_tpu_torch.smc import resize as RZ

# the module (the package's ``ops.max_scan`` attribute is the function)
ms = importlib.import_module("genparticlefilters_tpu_torch.ops.max_scan")
PKG = Path(tg.__file__).resolve().parent
NAN_B = 0x7FC00123  # a NaN whose bits differ from torch's


@pytest.fixture
def card():
    """The card, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (this machine has none)")
    return torch.device("cuda")


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _serial(x):
    """torch.cummax's rule, element by element, on the last axis."""
    out = x.clone()
    flat, res = x.reshape(-1, x.shape[-1]), out.reshape(-1, x.shape[-1])
    for r in range(flat.shape[0]):
        run = None
        for i in range(flat.shape[1]):
            v = flat[r, i]
            if run is None or bool(torch.isnan(v)) or (
                    not bool(torch.isnan(run)) and bool(v >= run)):
                run = v
            res[r, i] = run
    return out


def _nan_b():
    return torch.tensor([NAN_B], dtype=torch.int32).view(torch.float32)[0]


def _case(kind, dtype, shape, gen, device="cpu"):
    """An input of ``shape`` made on the CPU from ``gen``, moved to
    ``device``."""
    n = math.prod(shape)
    if kind == "random":
        x = (torch.randn(n, generator=gen) if dtype == torch.float32
             else torch.randint(-1000, 1000, (n,), generator=gen,
                                dtype=torch.int32))
    elif kind == "dips":
        # a rising scan with one-ulp (float) or unit (int) dips planted
        if dtype == torch.float32:
            x = torch.cumsum(torch.rand(n, generator=gen), 0)
            at = torch.rand(n, generator=gen) < 0.05
            x = torch.where(at, torch.nextafter(x, torch.tensor(-math.inf)),
                            x)
        else:
            x = torch.cumsum(torch.randint(0, 3, (n,), generator=gen), 0)
            at = torch.rand(n, generator=gen) < 0.05
            x = (x - at.to(x.dtype)).to(torch.int32)
    elif kind == "nan":
        x = torch.randn(n, generator=gen).to(dtype) if dtype == torch.float32 \
            else torch.randint(-5, 5, (n,), generator=gen, dtype=torch.int32)
        if dtype == torch.float32:
            rows = x.reshape(-1, shape[-1])
            rows[:, 0] = math.nan
            rows[:, shape[-1] // 2] = _nan_b()
            rows[:, -1] = math.nan
    elif kind == "zeros":
        if dtype == torch.float32:
            pick = torch.randint(0, 3, (n,), generator=gen)
            x = torch.tensor([0.0, -0.0, -1.0])[pick]
        else:
            x = torch.randint(-1, 1, (n,), generator=gen, dtype=torch.int32)
    elif kind == "constant":
        x = torch.full((n,), 7, dtype=dtype)
    elif kind == "descending":
        x = -torch.arange(n, dtype=torch.float64)
    else:
        raise ValueError(kind)
    return x.to(dtype).reshape(shape).to(device)


KINDS = ("random", "dips", "nan", "zeros", "constant", "descending")
DTYPES = (torch.int32, torch.float32)


# --- the wrapper -------------------------------------------------------------

def test_wrapper_refuses_what_the_kernel_does_not_take():
    for bad in (torch.zeros(4, dtype=torch.float64),
                torch.zeros(4, dtype=torch.int64),
                torch.zeros(4, dtype=torch.bool), [1.0, 2.0]):
        for fn in (max_scan, max_scan_plain):
            with pytest.raises(ValueError, match="int32 or float32"):
                fn(bad)
    for bad in (torch.zeros(8)[::2], torch.zeros(3, 4).t(),
                torch.tensor(1.0)):
        for fn in (max_scan, max_scan_plain):
            with pytest.raises(ValueError, match="contiguous"):
                fn(bad)
    with pytest.raises(ValueError, match="cpu or cuda"):
        max_scan(torch.zeros(4, device="meta"))
    before = max_scan.launches
    assert max_scan(torch.tensor([3, 1, 4, 1, 5], dtype=torch.int32)
                    ).tolist() == [3, 3, 4, 4, 5]
    assert max_scan.launches == before  # CPU: the plain version


@pytest.mark.parametrize("dtype", DTYPES, ids=("int32", "float32"))
@pytest.mark.parametrize("kind", KINDS)
def test_plain_is_torch_cummax_by_the_serial_rule(kind, dtype):
    gen = torch.Generator().manual_seed(7)
    for shape in ((1,), (2,), (33,), (300,), (4, 37), (2, 3, 9)):
        x = _case(kind, dtype, shape, gen)
        got = max_scan(x)
        assert _same_bits(got, torch.cummax(x, -1).values), (kind, shape)
        assert _same_bits(got, _serial(x)), (kind, shape)


def test_rule_on_the_edges():
    z = torch.tensor([0.0, -0.0, 0.0, -0.0, -1.0])
    got = max_scan(z)
    assert torch.equal(_bits(got), _bits(torch.tensor(
        [0.0, -0.0, 0.0, -0.0, -0.0])))  # a tie takes the later zero
    nb = _nan_b()
    x = torch.stack([torch.tensor(1.0), torch.tensor(math.nan),
                     torch.tensor(5.0), nb, torch.tensor(math.inf)])
    got = _bits(max_scan(x)).tolist()
    qnan = _bits(torch.tensor([math.nan])).item()
    assert got == [_bits(torch.tensor([1.0])).item(), qnan, qnan, NAN_B,
                   NAN_B]
    ints = torch.tensor([-2 ** 31, 2 ** 31 - 1, 0, -2 ** 31],
                        dtype=torch.int32)
    assert max_scan(ints).tolist() == [-2 ** 31] + [2 ** 31 - 1] * 3


# --- the kernel's tiling, transcribed ---------------------------------------

def test_plan_picks_the_tile_from_the_row_length():
    assert ms._TILES == (512, 4096)
    assert ms._plan(1, 1) == (512, 1, 0)
    assert ms._plan(512, 7) == (512, 1, 0)
    assert ms._plan(513, 7) == (4096, 1, 0)
    assert ms._plan(4096, 3) == (4096, 1, 0)
    assert ms._plan(4097, 3) == (4096, 2, 3 * 2 + 1)
    assert ms._plan(100_000, 1) == (4096, 25, 26)
    assert ms._plan(1_000_000, 1) == (4096, 245, 246)


def _op(a, b):
    """The kernel's combine, a before b, elementwise."""
    take_b = (b >= a) | torch.isnan(b)
    return torch.where(take_b, b, a)


def _tiled(x, tile):
    """The kernel's fold: each tile scanned alone, each tile's prefix the
    fold of the totals before it (the look-back), combined in order."""
    ident = (torch.tensor(-math.inf) if x.dtype == torch.float32
             else torch.tensor(-2 ** 31, dtype=torch.int32))
    out = torch.empty_like(x)
    for r in range(x.shape[0]):
        prior = ident
        for lo in range(0, x.shape[1], tile):
            part = _serial(x[r, lo:lo + tile])
            out[r, lo:lo + tile] = _op(prior, part)
            prior = _op(prior, part[-1])
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=("int32", "float32"))
@pytest.mark.parametrize("kind", KINDS)
def test_any_tiling_gives_torch_cummax_bits(kind, dtype):
    gen = torch.Generator().manual_seed(11)
    x = _case(kind, dtype, (2, 97), gen)
    want = torch.cummax(x, -1).values
    for tile in (1, 4, 7, 32, 96, 97, 128):
        assert _same_bits(_tiled(x, tile), want), (kind, tile)


# --- the call sites ----------------------------------------------------------

def test_no_torch_cummax_left_in_the_port():
    hits = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
            if re.search(r"\.cummax\s*\(", p.read_text())}
    assert hits == {"ops/max_scan.py"}


def _weights(n, seed):
    w = torch.rand(n, generator=torch.Generator().manual_seed(seed)) ** 4
    return w / w.sum()


def _routes():
    """(label, fn, the (dtype, shape) of each max_scan call)"""
    n, K, b = 64, 4, 16
    w = _weights(n, 1)
    wb = torch.stack([_weights(b, 2 + k) for k in range(K)])
    i32, f32 = torch.int32, torch.float32

    def g():
        return torch.Generator().manual_seed(5)
    counts = torch.tensor([0, 3, 1, 0, 2, 2], dtype=torch.int32)
    lw = torch.log(_weights(n, 9))
    st = tg.ParticleFilterState({"x": torch.arange(n, dtype=torch.int32)},
                                lw, torch.zeros(()),
                                torch.arange(n, dtype=torch.int32))
    return [
        ("systematic_F", lambda: R.systematic_F(g(), w), [(i32, (n,))]),
        ("stratified_F", lambda: R.stratified_F(g(), w), [(i32, (n,))]),
        ("multinomial_F", lambda: R.multinomial_F(g(), w),
         [(f32, (n + 1,)), (i32, (n,))]),
        ("residual_F", lambda: R.residual_F(g(), w),
         [(f32, (n + 1,)), (i32, (n,))]),
        ("residual_F_fused", lambda: R.residual_F_fused(g(), w),
         [(f32, (n,)), (f32, (n + 1,)), (i32, (n,))]),
        ("stratified_cu", lambda: R.stratified_cu(g(), w), [(f32, (n,))]),
        ("multinomial_cu", lambda: R.multinomial_cu(g(), w),
         [(f32, (n + 1,)), (f32, (n,))]),
        ("counts_to_parents", lambda: R.counts_to_parents(counts, 8),
         [(i32, (8,))]),
        ("blockwise systematic", lambda: R.blockwise_compose(
            g(), wb, "systematic"), [(i32, (K, b))]),
        ("blockwise stratified", lambda: R.blockwise_compose(
            g(), wb, "stratified"), [(f32, (K, b))]),
        ("blockwise multinomial", lambda: R.blockwise_compose(
            g(), wb, "multinomial"), [(f32, (K, b + 1)), (f32, (K, b))]),
        ("blockwise residual", lambda: R.blockwise_compose(
            g(), wb, "residual"),
         [(f32, (K, b)), (f32, (K, b + 1)), (i32, (K, b))]),
        ("pf_optimal_resize", lambda: RZ.pf_optimal_resize(
            None, st, n // 4, u=0.3), [(i32, (n,)), (i32, (n // 4,))]),
    ]


@pytest.mark.parametrize("route", range(13))
def test_every_former_cummax_site_goes_through_max_scan(route, monkeypatch):
    label, fn, want = _routes()[route]
    seen = []

    def recorder(x):
        seen.append((x.dtype, tuple(x.shape)))
        return max_scan(x)
    for mod in (R, RZ):
        monkeypatch.setattr(mod, "max_scan", recorder)
    got = fn()
    assert seen == want, label
    for mod in (R, RZ):
        monkeypatch.setattr(mod, "max_scan",
                            lambda x: torch.cummax(x, -1).values)
    ref = fn()
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        if isinstance(a, torch.Tensor):
            assert _same_bits(a, b), label


# --- on the card -------------------------------------------------------------

LENGTHS = (1, 2, 31, 32, 33, 511, 512, 513, 2047, 4095, 4096, 4097, 8191,
           8192, 8193, 100_000, 1_000_001)
ROWS = ((3, 100), (1000, 33), (64, 513), (5, 10_000), (7, 4096), (4, 4097),
        (2, 3, 1000), (2, 300_001))


def _check_on(dev, kind, dtype, shape, gen):
    x = _case(kind, dtype, shape, gen, dev)
    got = max_scan(x)
    want = torch.cummax(x, -1).values
    assert _same_bits(got, want), (kind, dtype, shape)
    assert _same_bits(got.cpu(), torch.cummax(x.cpu(), -1).values)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", DTYPES, ids=("int32", "float32"))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_is_torch_cummax_bit_for_bit(card, kind, dtype):
    gen = torch.Generator().manual_seed(3)
    before = max_scan.launches
    for shape in [(n,) for n in LENGTHS] + list(ROWS):
        _check_on(card, kind, dtype, shape, gen)
    assert max_scan.launches - before == len(LENGTHS) + len(ROWS)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", DTYPES, ids=("int32", "float32"))
def test_kernel_on_views_off_a_16_byte_boundary(card, dtype):
    gen = torch.Generator().manual_seed(4)
    for n in (513, 100_000, 1_000_001):
        big = _case("dips", dtype, (n + 3,), gen, card)
        for off in (1, 2, 3):
            x = big[off:off + n]
            assert _same_bits(max_scan(x), torch.cummax(x, -1).values)
    empty = torch.empty((0,), dtype=dtype, device=card)
    assert max_scan(empty).shape == (0,)


@pytest.mark.chip
def test_captured_scans_replay_bit_for_bit(card):
    shapes = (((1_000_001,), torch.float32), ((100_000,), torch.int32),
              ((64, 513), torch.float32), ((3, 9000), torch.int32))
    gen = torch.Generator().manual_seed(5)
    xs = [_case("dips", dt, sh, gen, card) for sh, dt in shapes]
    for x in xs:
        max_scan(x)  # built and warm before the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ys = [max_scan(x) for x in xs]
    ms.max_scan_runs(reset=True)
    bad = []
    for r in range(50):
        kind = KINDS[r % len(KINDS)]
        for x, (sh, dt) in zip(xs, shapes):
            x.copy_(_case(kind, dt, sh, gen, card))
        graph.replay()
        bad += [(r, kind, sh) for x, y, (sh, _) in zip(xs, ys, shapes)
                if not _same_bits(y, torch.cummax(x, -1).values)]
    assert not bad
    assert ms.max_scan_runs() == 50 * len(shapes)


@pytest.mark.chip
@pytest.mark.parametrize("n, method", [(1_000_000, "residual"),
                                       (100_000, "systematic")])
def test_captured_filters_equal_torch_cummax_ones(card, n, method,
                                                  monkeypatch):
    from genparticlefilters_tpu_torch.models import object_motion as om
    y_obs, _ = om.synthesize_data(
        torch.Generator(device=card).manual_seed(3), 10, 4)
    outs, runs = [], []
    for patched in (False, True):
        with monkeypatch.context() as mp:
            if patched:
                mp.setattr(R, "max_scan",
                           lambda x: torch.cummax(x, -1).values)
            gen = torch.Generator(device=card).manual_seed(0)
            run = om.object_motion_filter_captured(
                gen, y_obs, n, 10, ess_frac=0.5, resample_method=method)
        ms.max_scan_runs(reset=True)
        gen.manual_seed(11)
        st = run()
        runs.append(ms.max_scan_runs())
        outs.append((st.parents, st.log_weights, tg.log_ml_estimate(st)))
    assert runs[0] > 0 and runs[1] == 0
    for a, b in zip(*outs):
        assert _same_bits(a, b)
