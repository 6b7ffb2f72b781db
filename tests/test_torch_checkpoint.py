"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the
round trip, the atomic commit, keep-k, ``latest_step``, restore onto
another device, checkpoints across the two packages, and a resumed
training run equal to a straight one bit for bit.

The layout is the reference's (``repro.checkpoint``): a dict-of-arrays
checkpoint written by either package loads in the other. bfloat16 leaves
go to disk as their 16 bits under ``"dtype": "bfloat16"``, the tag the
reference writes over its 2-byte records, and come back bit for bit.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as r_load
from repro.checkpoint import save_pytree as r_save
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_pytree, save_pytree)
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.data.pipelines import lm_batch
from repro_torch.models import transformer as TT
from repro_torch.train import AdamWState, OptConfig, init_state
from repro_torch.train import make_train_step

torch.set_num_threads(1)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "i32": torch.arange(-6, 6, dtype=torch.int32).reshape(3, 4),
        "f32": torch.randn(5, 3, generator=g),
        "bf16": (torch.randn(4, 7, generator=g) * 1e3).to(torch.bfloat16),
        "nested": {"z": torch.zeros(2), "lst": [torch.ones(3),
                                                torch.full((2, 2), 7.0)]},
        "opt": AdamWState(torch.tensor(3, dtype=torch.int32),
                          {"w": torch.randn(3, generator=g)},
                          {"w": torch.rand(3, generator=g)}),
    }


def _template(tree):
    return _map(tree, torch.empty_like)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def test_round_trip_bitwise(tmp_path):
    tree = _tree()
    save_pytree(tree, str(tmp_path), 5, meta={"x": 1})
    out, meta = load_pytree(_template(tree), str(tmp_path), 5)
    assert meta == {"x": 1}
    assert isinstance(out["opt"], AdamWState)
    assert isinstance(out["nested"]["lst"], list)
    want, got = _flatten(tree), _flatten(out)
    assert set(got) == set(want)
    assert "opt[1].w" in got and "nested.lst[1]" in got
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        assert torch.equal(got[k].view(torch.int16) if w.dtype ==
                           torch.bfloat16 else got[k],
                           w.view(torch.int16) if w.dtype == torch.bfloat16
                           else w), k
    man = json.loads((tmp_path / "step_000000005" / "MANIFEST.json")
                     .read_text())
    assert man["leaves"]["bf16"]["dtype"] == "bfloat16"
    assert man["leaves"]["bf16"]["shape"] == [4, 7]
    assert man["leaves"]["opt[0]"]["dtype"] == "int32"


def test_dtypes_are_never_converted(tmp_path):
    save_pytree({"w": torch.ones(3, dtype=torch.bfloat16)}, str(tmp_path), 1)
    with pytest.raises(TypeError, match="bfloat16"):
        load_pytree({"w": torch.empty(3)}, str(tmp_path), 1)
    with pytest.raises(TypeError):     # a dtype numpy has no array for
        save_pytree({"w": torch.zeros(2, dtype=torch.float8_e4m3fn)},
                    str(tmp_path), 2)


def test_atomic_commit_and_keep_k(tmp_path):
    tree = {"w": torch.ones(4)}
    for s in (1, 2, 3, 4, 5):
        save_pytree(tree, str(tmp_path), s, keep=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_000000004", "step_000000005"]
    assert latest_step(str(tmp_path)) == 5
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_latest_step_ignores_uncommitted(tmp_path):
    """A write cut off before its rename leaves ``step_*.tmp``; a directory
    without a manifest is no checkpoint either."""
    save_pytree({"w": torch.ones(2)}, str(tmp_path), 3)
    (tmp_path / "step_000000009.tmp").mkdir()
    (tmp_path / "step_000000009.tmp" / "MANIFEST.json").write_text("{}")
    (tmp_path / "step_000000007").mkdir()
    assert latest_step(str(tmp_path)) == 3
    assert latest_step(str(tmp_path / "missing")) is None
    # a later save of step 9 commits over the stale temporary directory
    save_pytree({"w": torch.zeros(2)}, str(tmp_path), 9)
    assert latest_step(str(tmp_path)) == 9


def test_restore_places_leaves_on_devices(tmp_path):
    """``device=`` is one device or a tree of them (the reference's
    ``shardings=``); by default a leaf follows its template."""
    tree = {"a": torch.ones(3), "b": {"c": torch.arange(4)}}
    save_pytree(tree, str(tmp_path), 1)
    tmpl = {"a": torch.empty(3, device="meta"),
            "b": {"c": torch.empty(4, dtype=torch.int64, device="meta")}}
    out, _ = load_pytree(tmpl, str(tmp_path), 1, device="cpu")
    assert out["a"].device.type == out["b"]["c"].device.type == "cpu"
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    out, _ = load_pytree(tree, str(tmp_path), 1,
                         device={"a": "meta", "b": {"c": None}})
    assert out["a"].device.type == "meta"
    assert out["b"]["c"].device.type == "cpu"


def test_manager_saves_every_n_and_restores_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), every=2, keep=2)
    tmpl = {"w": torch.zeros(2)}
    assert mgr.restore_latest(tmpl, device="cpu") == (None, None, None)
    for s in range(0, 6):
        path = mgr.maybe_save(s, {"w": torch.full((2,), float(s))},
                              meta={"s": s})
        assert (path is not None) == (s in (2, 4))
    assert mgr.maybe_save(5, {"w": torch.full((2,), 5.0)}, force=True)
    step, tree, meta = mgr.restore_latest(tmpl, device="cpu")
    assert step == 5 and meta == {} and float(tree["w"][0]) == 5.0
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_000000004",
                                                   "step_000000005"]


def test_port_checkpoint_loads_in_reference(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.int32).reshape(3, 4),
            "b": {"c": torch.randn(2, 5, generator=torch.Generator()
                                   .manual_seed(1))}}
    save_pytree(tree, str(tmp_path), 4, meta={"by": "port"})
    tmpl = {"a": jnp.zeros((3, 4), jnp.int32), "b": {"c": jnp.zeros((2, 5))}}
    out, meta = r_load(tmpl, str(tmp_path), 4)
    assert meta == {"by": "port"}
    assert np.asarray(out["a"]).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(out["a"]), tree["a"].numpy())
    np.testing.assert_array_equal(np.asarray(out["b"]["c"]),
                                  tree["b"]["c"].numpy())


def test_reference_checkpoint_loads_in_port(tmp_path):
    rng = np.random.default_rng(2)
    f32 = rng.normal(size=(3, 6)).astype(np.float32)
    tree = {"a": jnp.asarray(f32), "b": {"c": jnp.arange(5, dtype=jnp.int32),
                                         "h": jnp.asarray(f32, jnp.bfloat16)},
            "l": [jnp.ones(2)]}
    r_save(tree, str(tmp_path), 8, meta={"by": "reference"})
    tmpl = {"a": torch.empty(3, 6), "b": {"c": torch.empty(5, dtype=torch.int32),
                                          "h": torch.empty(3, 6,
                                                           dtype=torch.bfloat16)},
            "l": [torch.empty(2)]}
    out, meta = load_pytree(tmpl, str(tmp_path), 8, device="cpu")
    assert meta == {"by": "reference"}
    assert torch.equal(out["a"], torch.from_numpy(f32))
    assert torch.equal(out["b"]["c"], torch.arange(5, dtype=torch.int32))
    want_h = np.asarray(tree["b"]["h"]).view(np.uint16)
    assert out["b"]["h"].dtype == torch.bfloat16
    assert np.array_equal(out["b"]["h"].view(torch.int16).numpy()
                          .view(np.uint16), want_h)
    assert torch.equal(out["l"][0], torch.ones(2))


def _state(model, opt):
    return {"params": model, "opt": opt}


def test_resumed_training_equals_straight_run_bitwise(tmp_path):
    """k steps, a checkpoint, a fresh model and state restored from it,
    then n - k steps: every parameter and moment equals n straight steps
    bit for bit, and the data order is the same (lm_batch per step)."""
    cfg = configs.get("qwen3-1.7b").make_reduced()
    n, k = 4, 2
    ocfg = OptConfig(warmup_steps=1, total_steps=n)
    step = make_train_step(lambda p, b: TT.loss_fn(cfg, p, b), ocfg, accum=2)

    def fresh(seed):
        m = TT.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        return m.requires_grad_(True)

    def run(model, opt, steps):
        losses = []
        for s in steps:
            model, opt, m = step(model, opt, lm_batch(s, 4, 16, cfg.vocab,
                                                      seed=7))
            losses.append(float(m["loss"]))
        return model, opt, losses

    model = fresh(0)
    model, opt, straight = run(model, init_state(model), range(n))

    first = fresh(0)
    first, opt1, head = run(first, init_state(first), range(k))
    save_pytree(_state(first, opt1), str(tmp_path), k, meta={"step": k})
    other = fresh(1)                       # other weights, overwritten
    tree, meta = load_pytree(_state(other, init_state(other)),
                             str(tmp_path), latest_step(str(tmp_path)))
    assert meta == {"step": k} and tree["params"] is other
    assert int(tree["opt"].step) == k
    assert all(p.requires_grad for p in other.parameters())
    resumed, opt2, tail = run(tree["params"], tree["opt"], range(k, n))

    assert head + tail == straight
    assert int(opt2.step) == int(opt.step) == n
    for (name, p), q in zip(model.named_parameters(), resumed.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(opt.m[name], opt2.m[name]), name
        assert torch.equal(opt.v[name], opt2.v[name]), name
