"""Checkpointing and profiling of the port (genparticlefilters_tpu_torch/
utils/checkpoint.py, utils/profiling.py).

- ``save_state``/``restore_state`` round-trip bit-equal (the JAX package's
  tests/test_utils_statistics.py:120-152 on the port's line model, batched
  and per particle, and an object-motion state whose Unfold length moved
  on), restore onto ``like``'s device, and the next update of the
  restored state is the update of the saved one from the same seed.
- Incompatible checkpoints raise: another particle count, another model,
  another dtype, a future ``format_version``.
- ``trace_profile`` writes a Chrome trace of its block; ``Timer.stop``
  returns the elapsed time.
"""

import json
import os

import pytest
import torch

import genparticlefilters_tpu_torch as tg
from genparticlefilters_tpu_torch.core.tree import tree_leaves
from genparticlefilters_tpu_torch.models import object_motion as tom
from genparticlefilters_tpu_torch.utils import (save_state, restore_state,
                                                trace_profile, Timer)
from genparticlefilters_tpu_torch.utils.checkpoint import FORMAT_VERSION
from test_torch_line_model import line_model, line_choicemap, G


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("marked", [True, False])
def test_checkpoint_roundtrip(tmp_path, marked):
    model = line_model
    if not marked:
        model = tg.gen(line_model.fn)
    state = tg.pf_initialize(G(0), model, (3,), line_choicemap(3), 32)
    p = str(tmp_path / "ckpt.pt")
    save_state(p, state)
    fresh = tg.pf_initialize(G(1), model, (3,), line_choicemap(3), 32)
    restored = restore_state(p, fresh)
    _equal(state, restored)
    assert torch.equal(tg.batched_choice(state, "slope"),
                       tg.batched_choice(restored, "slope"))


def test_checkpoint_restores_the_active_length_and_next_step(tmp_path):
    """A state four steps in, restored onto a fresh one-step ``like``: the
    Unfold's active length comes back, and one more update of each from
    the same seed is bit-equal."""
    y_obs, _ = tom.synthesize_data(G(42), 6, 3)
    x0, obs = tom.init_state("cpu"), tom.obs_dense(y_obs)
    model = tom.make_object_motion(6)
    st = tg.pf_initialize(G(1), model, (1, x0), obs, 64)
    for t in range(1, 4):
        st = tg.pf_update(G(10 + t), st, (t + 1, x0),
                          (tg.Extend(1), tg.NoChange()), obs, check=False)
    p = str(tmp_path / "om.pt")
    save_state(p, st)
    like = tg.pf_initialize(G(2), model, (1, x0), obs, 64)
    restored = restore_state(p, like)
    assert restored.traces.inner["t"] == 4
    _equal(st, restored)
    nxt = [tg.pf_update(G(7), s, (5, x0), (tg.Extend(1), tg.NoChange()),
                        obs, check=False) for s in (st, restored)]
    _equal(*nxt)


def test_checkpoint_incompatible_raises(tmp_path):
    state = tg.pf_initialize(G(0), line_model, (3,), line_choicemap(3), 32)
    p = str(tmp_path / "ckpt.pt")
    save_state(p, state)
    wrong_n = tg.pf_initialize(G(1), line_model, (3,), line_choicemap(3), 16)
    with pytest.raises(ValueError, match="different particle count"):
        restore_state(p, wrong_n)
    y_obs, _ = tom.synthesize_data(G(42), 6, 3)
    other = tg.pf_initialize(G(1), tom.make_object_motion(6),
                             (1, tom.init_state("cpu")), tom.obs_dense(y_obs),
                             32)
    with pytest.raises(ValueError, match="data leaves"):
        restore_state(p, other)
    wrong_dtype = state.replace(log_weights=state.log_weights.double())
    with pytest.raises(ValueError, match="dtype"):
        restore_state(p, wrong_dtype)


def test_checkpoint_future_format_version_raises(tmp_path):
    state = tg.pf_initialize(G(0), line_model, (3,), line_choicemap(3), 8)
    p = str(tmp_path / "ckpt.pt")
    save_state(p, state)
    blob = torch.load(p, weights_only=True)
    meta = json.loads(blob["meta"])
    assert meta["format_version"] == FORMAT_VERSION
    meta["format_version"] = FORMAT_VERSION + 1
    torch.save({"meta": json.dumps(meta), "tensors": blob["tensors"]}, p)
    with pytest.raises(ValueError, match="newer than this library"):
        restore_state(p, state)


def test_trace_profile_and_timer(tmp_path):
    logdir = str(tmp_path / "prof")
    with Timer() as t:
        with trace_profile(logdir) as prof:
            st = tg.pf_initialize(G(0), line_model, (2,), line_choicemap(2),
                                  64)
        elapsed = t.stop(st)
    assert elapsed > 0 and t.elapsed >= elapsed
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0
    assert len(prof.key_averages()) > 0
