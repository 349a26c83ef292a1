"""The ESS check as one kernel (genparticlefilters_tpu_torch/ops/ess_check.py,
csrc/ess_check.cu).

On the CPU: ``ess_below``'s plain version is the chain it replaces,
``ess_from_log_weights(lw) < threshold``, bit for bit on random,
degenerate, uniform, wide, partly -inf and near-threshold vectors; the
edge cases (a NaN weight, every weight -inf, a +inf weight, N = 1,
ess_frac 0, 1 and 1.5); the kernel's grid from the length alone; the
wrapper's refusals of what the kernel does not take, checked before any
launch (so on meta tensors here); the drivers' ESS check on a CPU state
going through ``ess_below``'s plain route; and tempered SMC's first check,
on the equal weights that ``pf_initialize`` leaves without constraints,
taking the chain's branch at ess_frac 0.5, 1 and 1.5.

Marked ``chip``, on the card (this file imports no JAX: run it there with
``python -m pytest --noconftest tests/test_torch_ess_check.py -m chip``):
the kernel against its plain version at N = 1, 4,097, 100K, 500K and 1M
and on views off a 16-byte boundary (equal predicates, the ESS within
1e-5 relative of the chain's); equal weights, where the kernel's ESS is
the chain's to the bit, so that ess_frac 1 takes the chain's branch, in
tempered SMC too; a captured check replayed bit for bit; one graph node a
check where the chain took many; and the drivers' checks counted by the
kernel's own counter in a captured filter.
"""

import math
import types

import pytest
import torch

import genparticlefilters_tpu_torch as tg
from genparticlefilters_tpu_torch.ops import ess_check as ec
from genparticlefilters_tpu_torch.ops.ess_check import (ess_below,
                                                        ess_below_plain)
from genparticlefilters_tpu_torch.smc import algorithms
from genparticlefilters_tpu_torch.smc.capture import host_pred
from genparticlefilters_tpu_torch.utils.weights import ess_from_log_weights

FINITE = ("random", "degenerate", "uniform", "wide", "partly_neginf")
NONFINITE = ("nan", "all_neginf", "posinf")
FRACS = (0.0, 0.25, 0.5, 1.0, 1.5)


@pytest.fixture
def card():
    """The card, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (this machine has none)")
    return torch.device("cuda")


def _lw(kind, n, gen, device="cpu"):
    """``n`` float32 log weights of ``kind``, made on the CPU from
    ``gen``, moved to ``device``."""
    x = torch.randn(n, generator=gen)
    if kind == "random":
        x = 2.0 * x
    elif kind == "degenerate":
        x[n // 3] += 60.0  # one weight dominates: ESS ~ 1
    elif kind == "uniform":
        x = torch.full((n,), -3.25)
    elif kind == "wide":
        x = 40.0 * x  # most exp terms underflow
    elif kind == "partly_neginf":
        x[::3] = -math.inf
        x[n // 2] = 0.5
    elif kind == "nan":
        x[n // 2] = math.nan
    elif kind == "all_neginf":
        x = torch.full((n,), -math.inf)
    elif kind == "posinf":
        x[n // 4] = math.inf
    else:
        raise ValueError(kind)
    return x.to(torch.float32).to(device)


def _thresholds(lw):
    """ess_frac x N for :data:`FRACS`, and, where the ESS is finite,
    the ESS itself and its float32 neighbours."""
    n = lw.shape[0]
    out = [f * n for f in FRACS] + [math.inf]
    ess = ess_from_log_weights(lw.cpu())
    if bool(torch.isfinite(ess)):
        inf = torch.tensor(math.inf)
        out += [float(ess), float(torch.nextafter(ess, inf)),
                float(torch.nextafter(ess, -inf))]
    return out


def _bits(x):
    return x.view(torch.int32)


# --- the plain version -------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 1000, 4097])
@pytest.mark.parametrize("kind", FINITE + NONFINITE)
def test_plain_is_the_chain_bit_for_bit(kind, n):
    lw = _lw(kind, n, torch.Generator().manual_seed(n))
    want_ess = ess_from_log_weights(lw)
    before = ess_below.launches
    for thr in _thresholds(lw):
        want = want_ess < thr
        for fn in (ess_below, ess_below_plain):
            got = fn(lw, thr)
            assert got.dtype == torch.bool and got.shape == ()
            assert bool(got) == bool(want), (kind, n, thr)
            low, ess = fn(lw, thr, with_ess=True)
            assert bool(low) == bool(want)
            assert torch.equal(_bits(ess), _bits(want_ess))
    assert ess_below.launches == before  # CPU: the plain version


def _edge(case):
    """(log weights, [(threshold, expected predicate)])"""
    g = torch.Generator().manual_seed(5)
    if case in NONFINITE:
        lw = _lw(case, 1000, g)
        return lw, [(f * 1000, False) for f in FRACS] + [(math.inf, False)]
    if case == "n1":
        lw = torch.tensor([0.3])
        return lw, [(0.0, False), (0.5, False), (1.0, False), (1.5, True),
                    (math.inf, True)]
    if case == "frac0":
        return [(_lw(k, 1000, g), 0.0, False) for k in FINITE]
    if case == "frac1.5":
        return [(_lw(k, 1000, g), 1500.0, True) for k in FINITE]
    raise ValueError(case)


@pytest.mark.parametrize("case", NONFINITE + ("n1", "frac0", "frac1.5"))
def test_edge_cases(case):
    got = _edge(case)
    rows = ([(got[0], thr, want) for thr, want in got[1]]
            if isinstance(got, tuple) else got)
    for lw, thr, want in rows:
        assert bool(ess_below(lw, thr)) is want, (case, thr)
        assert bool(ess_from_log_weights(lw) < thr) is want, (case, thr)
    if case == "n1":
        assert float(ess_from_log_weights(got[0])) == 1.0


# --- the wrapper --------------------------------------------------------------

def test_blocks_follow_the_length_alone():
    assert (ec._PER_BLOCK, ec._MAX_BLOCKS) == (4096, 1024)
    got = {n: ec._blocks(n) for n in (0, 1, 4096, 4097, 100_000, 500_000,
                                      1_000_000, 4096 * 1024,
                                      4096 * 1024 + 1, 10 ** 8)}
    assert got == {0: 1, 1: 1, 4096: 1, 4097: 2, 100_000: 25, 500_000: 123,
                   1_000_000: 245, 4096 * 1024: 1024, 4096 * 1024 + 1: 1024,
                   10 ** 8: 1024}


@pytest.mark.parametrize("case", ["2-D", "non-contiguous", "float64",
                                  "float16", "0-D", "not a tensor", "meta"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    meta = torch.device("meta")
    x, match = {
        "2-D": (torch.zeros(4, 2, device=meta), "contiguous 1-D"),
        "non-contiguous": (torch.zeros(8, device=meta)[::2],
                           "contiguous 1-D"),
        "float64": (torch.zeros(4, dtype=torch.float64, device=meta),
                    "float32"),
        "float16": (torch.zeros(4, dtype=torch.float16, device=meta),
                    "float32"),
        "0-D": (torch.zeros((), device=meta), "contiguous 1-D"),
        "not a tensor": ([0.0, 1.0], "tensor"),
        "meta": (torch.zeros(4, device=meta), "cpu or cuda"),
    }[case]
    before = ess_below.launches
    with pytest.raises(ValueError, match=match):
        ess_below(x, 2.0)
    assert ess_below.launches == before


# --- the drivers' check on a CPU state ---------------------------------------

@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0, 1.5, math.inf])
def test_ess_low_takes_the_plain_route_on_a_cpu_state(frac, monkeypatch):
    n = 500
    lw = _lw("random", n, torch.Generator().manual_seed(3))
    state = tg.ParticleFilterState({"x": torch.zeros(n)}, lw,
                                   torch.zeros(()),
                                   torch.arange(n, dtype=torch.int32))
    calls = []

    def recorder(log_weights, threshold, **kw):
        calls.append((log_weights, threshold))
        return ess_below(log_weights, threshold, **kw)
    monkeypatch.setattr(algorithms, "ess_below", recorder)
    reads, launches = host_pred.reads, ess_below.launches
    got = algorithms._ess_low(state, frac, "test")
    assert got is bool(tg.effective_sample_size(state)
                       < frac * tg.num_particles(state))
    assert len(calls) == 1 and calls[0][0] is lw
    assert calls[0][1] == frac * n
    assert host_pred.reads == reads + 1
    assert ess_below.launches == launches


def _tempered_checks(gen, n, frac, fn, monkeypatch):
    """Tempered SMC's ESS checks (log weights, threshold, predicate) with
    ``fn`` as the drivers' check, and its log ML estimate."""
    from genparticlefilters_tpu_torch.models import tempered as ttm
    seen = []

    def recorder(log_weights, threshold, **kw):
        low = fn(log_weights, threshold, **kw)
        seen.append((log_weights.clone(), threshold, bool(low)))
        return low
    monkeypatch.setattr(algorithms, "ess_below", recorder)
    _, lml = ttm.run_tempered_smc(gen, n, 6, 1, ess_frac=frac)
    monkeypatch.undo()
    return seen, lml


@pytest.mark.parametrize("frac", [0.5, 1.0, 1.5])
def test_tempered_smcs_first_check_takes_the_chains_branch(frac,
                                                           monkeypatch):
    """``pf_initialize`` without constraints leaves equal weights, so at
    ess_frac 1 tempered SMC's first check decides on the rounding of an
    ESS of N: on the CPU the plain route is the chain, so is its branch."""
    n = 300
    seen, _ = _tempered_checks(torch.Generator().manual_seed(7), n, frac,
                               ess_below, monkeypatch)
    lw, thr, low = seen[0]
    assert bool((lw == lw[0]).all()) and thr == frac * n
    assert low is bool(ess_from_log_weights(lw) < thr)
    assert len(seen) == 5
    if frac != 1.0:
        assert low is (frac > 1.0)


# --- on the card ----------------------------------------------------------------

SIZES = (1, 4097, 100_000, 500_000, 1_000_000)


def _compare_on(card, lw):
    """The kernel against its plain version on ``lw`` (on the card) at
    every threshold: the predicates equal away from the threshold, the
    ESS within 1e-5 relative of the chain's, NaN and false where the plain
    ESS is not finite."""
    for thr in _thresholds(lw):
        low, ess = ess_below(lw, thr, with_ess=True)
        plow, pess = ess_below_plain(lw, thr, with_ess=True)
        e, pe = float(ess), float(pess)
        if math.isnan(pe) or math.isinf(pe):
            assert math.isnan(e) and not bool(low), (thr, e, pe)
            assert not bool(plow)
            continue
        assert e == pytest.approx(pe, rel=1e-5), (thr, e, pe)
        if abs(pe - thr) > 1e-4 * pe:
            assert bool(low) == bool(plow), (thr, e, pe)


@pytest.mark.chip
@pytest.mark.parametrize("kind", FINITE + NONFINITE)
def test_kernel_matches_plain_on_the_card(card, kind):
    before = ess_below.launches
    for n in SIZES:
        _compare_on(card, _lw(kind, n, torch.Generator().manual_seed(n),
                              card))
    assert ess_below.launches > before


@pytest.mark.chip
def test_kernel_on_views_off_a_16_byte_boundary(card):
    gen = torch.Generator().manual_seed(9)
    for n in (5, 4097, 1_000_001):
        big = _lw("random", n + 3, gen, card)
        for off in (1, 2, 3):
            _compare_on(card, big[off:off + n])


@pytest.mark.chip
@pytest.mark.parametrize("value", [0.0, -3.25, 17.5, -1000.3])
def test_equal_weights_give_the_chains_ess_to_the_bit(card, value):
    """Equal weights put the ESS at N up to rounding, so ess_frac 1 decides
    on that rounding: the kernel's is the chain's, and so is the branch."""
    for n in SIZES + (7, 123_457):
        lw = torch.full((n,), value, device=card)
        for frac in FRACS:
            low, ess = ess_below(lw, frac * n, with_ess=True)
            plow, pess = ess_below_plain(lw, frac * n, with_ess=True)
            assert torch.equal(_bits(ess), _bits(pess)), (n, float(ess),
                                                          float(pess))
            assert bool(low) == bool(plow), (n, frac)


@pytest.mark.chip
@pytest.mark.parametrize("frac", [0.5, 1.0, 1.5])
def test_tempered_smc_takes_the_chains_branches_on_the_card(card, frac,
                                                            monkeypatch):
    runs = {name: _tempered_checks(torch.Generator(device=card).manual_seed(7),
                                   100_000, frac, fn, monkeypatch)
            for name, fn in (("kernel", ess_below),
                             ("chain", ess_below_plain))}
    (k_seen, k_lml), (c_seen, c_lml) = runs["kernel"], runs["chain"]
    first = k_seen[0][0]
    assert bool((first == first[0]).all())  # pf_initialize's equal weights
    assert [s[2] for s in k_seen] == [s[2] for s in c_seen]
    assert torch.equal(_bits(k_lml), _bits(c_lml))


@pytest.mark.chip
def test_captured_check_replays_bit_for_bit(card):
    gen = torch.Generator().manual_seed(13)
    xs = [_lw("random", n, gen, card) for n in (1_000_000, 100_000, 4097)]
    thrs = [0.5 * x.shape[0] for x in xs]
    for x, t in zip(xs, thrs):
        ess_below(x, t, with_ess=True)  # built and warm before the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ess_below(x, t, with_ess=True) for x, t in zip(xs, thrs)]
    ec.ess_check_runs(reset=True)
    first = None
    for _ in range(20):
        graph.replay()
        got = [(bool(low), int(_bits(e))) for low, e in outs]
        first = first or got
        assert got == first
    eager = [ess_below(x, t, with_ess=True) for x, t in zip(xs, thrs)]
    assert [(bool(low), int(_bits(e))) for low, e in eager] == first
    for r in range(10):
        kind = FINITE[r % len(FINITE)]
        for x in xs:
            x.copy_(_lw(kind, x.shape[0], gen, card))
        graph.replay()
        for x, t, (low, e) in zip(xs, thrs, outs):
            low2, e2 = ess_below(x, t, with_ess=True)
            assert bool(low) == bool(low2) and torch.equal(_bits(e),
                                                           _bits(e2))
    # 30 replays of 3 checks, and 3 + 10 x 3 eager checks
    assert ec.ess_check_runs() == 30 * 3 + 3 + 10 * 3


@pytest.mark.chip
def test_one_graph_node_a_check(card, monkeypatch):
    from genparticlefilters_tpu_torch.utils.spans import _graph_nodes
    lw = _lw("random", 100_000, torch.Generator().manual_seed(2), card)
    state = types.SimpleNamespace(log_weights=lw, n_particles=100_000,
                                  mesh=None)
    found = {}
    for route in ("kernel", "chain"):
        if route == "chain":
            monkeypatch.setattr(algorithms, "ess_below", ess_below_plain)
        algorithms._ess_low(state, 0.5, "test")  # warm
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            a = _graph_nodes()
            low = algorithms._ess_low(state, 0.5, "test")
            b = _graph_nodes()
        graph.replay()
        found[route] = ({k: b[k] - a[k] for k in a}, bool(low))
    print(found)
    assert found["kernel"][0] == {"nodes": 1, "kernels": 1, "markers": 0,
                                  "conditionals": 0}
    assert found["chain"][0]["nodes"] >= 8
    assert found["kernel"][1] == found["chain"][1]


@pytest.mark.chip
def test_the_captured_filter_checks_through_the_kernel(card):
    from genparticlefilters_tpu_torch.models import object_motion as om
    y, _ = om.synthesize_data(torch.Generator(device=card).manual_seed(3),
                              10, 4)
    gen = torch.Generator(device=card).manual_seed(0)
    run = om.object_motion_filter_captured(gen, y, 100_000, 10,
                                           resample_method="systematic")
    ec.ess_check_runs(reset=True)
    for _ in range(3):
        run(y)
    assert ec.ess_check_runs() == 3 * 9
