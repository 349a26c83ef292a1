"""GFI verbs of the port (genparticlefilters_tpu_torch/core/gfi.py):
generate / update / regenerate weights checked by hand against the Gen
contract, with normal and bernoulli sites, in batched interpretation and
per particle (the port's counterpart of tests/test_gfi.py). Float32
throughout: atol 1e-5."""

import math

import numpy as np
import pytest
import torch

import genparticlefilters_tpu_torch as g
from genparticlefilters_tpu_torch.core.gfi import batched_interpretation

N = 5


def lp_normal(x, mu, s):
    return -0.5 * ((x - mu) / s) ** 2 - math.log(s) - 0.5 * math.log(
        2 * math.pi)


def lp_bern(v, p):
    return math.log(p) if v else math.log(1 - p)


@g.gen
def _model(mu):
    b = g.trace("b", g.bernoulli(0.3))
    x = g.trace("x", g.normal(mu, torch.where(b, 2.0, 1.0)))
    return g.trace("y", g.normal(x, 1.0))


_model.batch_safe = True


def _vals(tr):
    c = tr.get_choices()
    return (np.atleast_1d(c[("b",)].numpy()),
            np.atleast_1d(c[("x",)].numpy().astype(np.float64)),
            np.atleast_1d(c[("y",)].numpy().astype(np.float64)))


def _run(batch, fn):
    with batched_interpretation(batch):
        return fn()


@pytest.mark.parametrize("batch", [N, None])
def test_generate_weight_and_score_exact(batch):
    gen = torch.Generator().manual_seed(1)
    obs = g.ChoiceMap({("y",): g.Entry(torch.tensor(0.7), True)})
    tr, w = _run(batch, lambda: _model.generate(gen, (torch.tensor(0.2),),
                                                obs))
    b, x, y = _vals(tr)
    assert np.all(y == np.float32(0.7))
    k = 1 if batch is None else N
    assert tuple(w.shape) == (() if batch is None else (N,))
    for i in range(k):
        s = 2.0 if b[i] else 1.0
        xi = x[i]
        want_w = lp_normal(0.7, xi, 1.0)
        want_s = lp_bern(b[i], 0.3) + lp_normal(xi, 0.2, s) + want_w
        np.testing.assert_allclose(np.atleast_1d(w.numpy())[i], want_w,
                                   atol=1e-5)
        np.testing.assert_allclose(np.atleast_1d(tr.score.numpy())[i],
                                   want_s, atol=1e-5)


def test_generate_masked_per_particle_constraint():
    gen = torch.Generator().manual_seed(2)
    mask = torch.tensor([True, False, True, False, True])
    xs = torch.tensor([0.1, 9.0, -0.3, 9.0, 2.0])
    obs = g.ChoiceMap({("x",): g.Entry(xs, mask),
                       ("y",): g.Entry(torch.tensor(0.0), True)})
    tr, w = _run(N, lambda: _model.generate(gen, (torch.tensor(0.0),), obs))
    b, x, _ = _vals(tr)
    for i in range(N):
        s = 2.0 if b[i] else 1.0
        if mask[i]:
            assert x[i] == np.float32(xs[i])
        want = lp_normal(0.0, x[i], 1.0) + (
            lp_normal(x[i], 0.0, s) if mask[i] else 0.0)
        np.testing.assert_allclose(w[i].item(), want, atol=1e-5)


def test_update_overwrite_discards_and_weighs():
    gen = torch.Generator().manual_seed(3)
    obs = g.ChoiceMap({("y",): g.Entry(torch.tensor(0.7), True)})
    tr, _ = _run(N, lambda: _model.generate(gen, (torch.tensor(0.2),), obs))
    b, x, _ = _vals(tr)
    obs2 = g.ChoiceMap({("y",): g.Entry(torch.tensor(-1.5), True)})
    tr2, w, _, disc = _run(N, lambda: g.update(
        gen, tr, (torch.tensor(0.2),), (g.NoChange(),), obs2))
    e = disc.resolve(("y",))
    assert e is not None and float(e.value) == np.float32(0.7)
    for i in range(N):
        np.testing.assert_allclose(
            w[i].item(), lp_normal(-1.5, x[i], 1.0) - lp_normal(0.7, x[i],
                                                                 1.0),
            atol=1e-5)
    # changed args, nothing constrained: every choice is reused and
    # rescored; weight = Δ log p(x | mu)
    tr3, w3, _, disc3 = _run(N, lambda: g.update(
        gen, tr, (torch.tensor(1.1),), (g.UnknownChange(),), g.EMPTY))
    assert not disc3.entries
    np.testing.assert_array_equal(_vals(tr3)[1], x)
    for i in range(N):
        s = 2.0 if b[i] else 1.0
        np.testing.assert_allclose(
            w3[i].item(), lp_normal(x[i], 1.1, s) - lp_normal(x[i], 0.2, s),
            atol=1e-5)


@pytest.mark.parametrize("batch", [N, None])
def test_regenerate_weight_exact(batch):
    """Regenerating x from its prior:
    weight = lp(y | x_new) − lp(y | x_old)."""
    gen = torch.Generator().manual_seed(4)
    obs = g.ChoiceMap({("y",): g.Entry(torch.tensor(0.7), True)})
    tr, _ = _run(batch, lambda: _model.generate(gen, (torch.tensor(0.2),),
                                                obs))
    b, x_old, _ = _vals(tr)
    for _ in range(3):
        tr2, w = _run(batch, lambda: g.regenerate(
            gen, tr, (torch.tensor(0.2),), (g.NoChange(),), g.select("x")))
        b2, x_new, y2 = _vals(tr2)
        np.testing.assert_array_equal(b2, b)
        assert np.all(y2 == np.float32(0.7))
        wv = np.atleast_1d(w.numpy())
        for i in range(len(wv)):
            np.testing.assert_allclose(
                wv[i], lp_normal(0.7, x_new[i], 1.0)
                - lp_normal(0.7, x_old[i], 1.0), atol=1e-5)


@pytest.mark.parametrize("batch", [N, None])
def test_simulate_score_is_sum_of_site_logprobs(batch):
    gen = torch.Generator().manual_seed(6)
    tr = _run(batch, lambda: g.simulate(_model, gen, (torch.tensor(-0.4),)))
    b, x, y = _vals(tr)
    for i in range(len(b)):
        s = 2.0 if b[i] else 1.0
        want = (lp_bern(b[i], 0.3) + lp_normal(x[i], -0.4, s)
                + lp_normal(y[i], x[i], 1.0))
        np.testing.assert_allclose(np.atleast_1d(tr.score.numpy())[i], want,
                                   atol=1e-5)


def test_sites_outside_an_interpreter_raise():
    with pytest.raises(RuntimeError):
        g.trace("x", g.normal(0.0, 1.0))


@pytest.mark.parametrize("batch", [N, None])
def test_propose_and_assess_score_the_same_choices(batch):
    """propose returns the choices and score of a fresh simulation; assess
    of those choices gives the same score and retval."""
    gen = torch.Generator().manual_seed(7)
    choices, score, retval = _run(batch, lambda: _model.propose(
        gen, (torch.tensor(0.3),)))
    r2, s2 = _run(batch, lambda: g.assess(_model, (torch.tensor(0.3),),
                                          choices))
    np.testing.assert_allclose(s2.numpy(), score.numpy(), atol=1e-6)
    assert torch.equal(r2, retval)
    with pytest.raises(ValueError, match="missing choice"):
        g.assess(_model, (torch.tensor(0.3),),
                 g.ChoiceMap({("b",): choices.resolve(("b",))}))


_HOST_CHOICES = (("b", True), ("x", 0.5), ("y", -0.25))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_assess_scores_on_the_device_of_its_args(device):
    """A choicemap built from Python values names no device: assess scores
    it on the device of its args (``meta`` stands in for the card here, so
    a score left on the CPU would show), and raises when nothing names
    one."""
    r, s = g.assess(_model, (torch.tensor(0.3, device=device),),
                    g.choicemap(*_HOST_CHOICES))
    assert s.device.type == device and r.device.type == device
    if device == "cpu":
        want = (lp_bern(True, 0.3) + lp_normal(0.5, 0.3, 2.0)
                + lp_normal(-0.25, 0.5, 1.0))
        np.testing.assert_allclose(float(s), want, atol=1e-5)
    with pytest.raises(ValueError, match="device"):
        g.assess(_model, (0.3,), g.choicemap(*_HOST_CHOICES))


@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA card")
def test_assess_of_host_choices_with_card_args_scores_on_the_card():
    r, s = g.assess(_model, (torch.tensor(0.3, device="cuda"),),
                    g.choicemap(*_HOST_CHOICES))
    assert s.device.type == "cuda" and r.device.type == "cuda"


def test_select_trace_keeps_shared_leaves_and_args():
    """The default accept/reject select: per-particle leaves by the mask,
    a shared observed site and the stored args passed through."""
    gen = torch.Generator().manual_seed(8)
    obs = g.ChoiceMap({("y",): g.Entry(torch.tensor(0.7), True)})
    old, _ = _run(N, lambda: _model.generate(gen, (torch.tensor(0.2),), obs))
    new, _ = _run(N, lambda: g.regenerate(gen, old, (torch.tensor(0.2),),
                                          (g.NoChange(),), g.select("x")))
    accept = torch.tensor([True, False, True, False, False])
    out = _model.select_trace(accept, new, old)
    assert out.args is new.args
    assert out.inner["sites"][("y",)].value.dim() == 0
    want = torch.where(accept, new["x"], old["x"])
    assert torch.equal(out["x"], want)
    assert torch.equal(out.score, torch.where(accept, new.score, old.score))
