"""The port's checkpoints, restartable loop and training launcher, on
the CPU.

Checkpoints share the reference's on-disk layout: a ``(params,
opt_state)`` tree of the qwen3 smoke model in bfloat16 after one AdamW
step (bf16 parameters, f32 moments and master weights, an int32 step)
written by the JAX package restores in the port bit for bit, and the
port's restores in the JAX package bit for bit, with the same manifest.
A run preempted by SIGTERM and resumed from its checkpoint ends bitwise
where an uninterrupted run ends.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get as jget
from repro.models import transformer as JT
from repro.train import checkpoint as jckpt, optimizer as jopt
from repro_torch import configs
from repro_torch.data.synthetic import LMTokenStream
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt, failure, loop, \
    optimizer as opt
from repro_torch.train.tree import flatten_with_path, leaves, path_str
from release_xla import release_compiled  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"


def _to_torch(tree):
    """A jax pytree of dicts as the port's tree: every leaf a CPU tensor
    of the same dtype and bits."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(x):
    """A leaf's bits, for a bitwise comparison across the packages."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.fixture(scope="module")
def state():
    """The reference's (params, opt_state) of the bf16 qwen3 smoke model
    after one AdamW step (nonzero moments), and the port's copy."""
    cfg = dataclasses.replace(jget("qwen3-0.6b").smoke_config(),
                              dtype=jnp.bfloat16)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    ocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=1)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, ostate, _ = jopt.adamw_update(params, grads,
                                          jopt.adamw_init(params, ocfg), ocfg)
    tree = (params, ostate)
    return tree, _to_torch(tree)


def test_reference_checkpoint_restores_in_the_port(state, tmp_path):
    jtree, ttree = state
    jckpt.save(str(tmp_path), 7, jtree, meta={"by": "reference"})
    assert ckpt.latest_step(str(tmp_path)) == 7
    target = (jax.tree.map(lambda t: torch.zeros_like(t), ttree[0]),
              jax.tree.map(lambda t: torch.zeros_like(t), ttree[1]))
    got, manifest = ckpt.restore(str(tmp_path), target_tree=target)
    assert manifest["step"] == 7 and manifest["meta"] == {"by": "reference"}
    pairs = list(zip(flatten_with_path(got), flatten_with_path(ttree)))
    assert len(pairs) == len(jax.tree.leaves(jtree))
    for (path, g), (_, w) in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape, path_str(path)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=path_str(path))
    assert got[0]["embed"].dtype == torch.bfloat16
    assert got[1]["step"].dtype == torch.int32 and int(got[1]["step"]) == 1


def test_port_checkpoint_restores_in_the_reference(state, tmp_path):
    jtree, ttree = state
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    final = ckpt.save(str(port_dir), 3, ttree)
    assert final.endswith("step_00000003")
    jckpt.save(str(ref_dir), 3, jtree)
    load = lambda d: json.loads((d / "step_00000003" /
                                 "manifest.json").read_text())
    assert load(port_dir) == load(ref_dir)          # names, files, dtypes
    got, _ = jckpt.restore(str(port_dir), target_tree=jtree)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # the untargeted forms agree too (bf16 as its float32 values)
    mine, _ = ckpt.restore(str(ref_dir))
    theirs, _ = jckpt.restore(str(port_dir))
    assert sorted(mine) == sorted(theirs)
    for name in mine:
        np.testing.assert_array_equal(mine[name], theirs[name])


def test_restore_places_leaves_on_the_target(state, tmp_path):
    _, ttree = state
    ckpt.save(str(tmp_path), 1, ttree)
    ckpt.save(str(tmp_path), 2, ttree)
    target = (jax.tree.map(lambda t: torch.zeros(t.shape,
                                                 dtype=torch.float32),
                           ttree[0]), ttree[1])
    got, _ = ckpt.restore(str(tmp_path), 1, target_tree=target)
    assert all(t.dtype == torch.float32 for t in leaves(got[0]))
    assert torch.equal(got[0]["embed"], ttree[0]["embed"].float())
    bad = ({"embed": torch.zeros(3, 3)}, {})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), target_tree=bad)
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(str(tmp_path), target_tree=({"nope": torch.zeros(1)},))
    path, writer = ckpt.save(str(tmp_path), 9, ttree, blocking=False)
    writer.join(timeout=60)
    assert not writer.is_alive() and ckpt.latest_step(str(tmp_path)) == 9
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"))


def _train(tmp, n_steps, preempt_at=None):
    cfg = configs.get("qwen3-0.6b").smoke_config()
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=n_steps)
    stream = LMTokenStream(cfg.vocab, seed=0)

    def make_batch(i):
        if i == preempt_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return {"tokens": stream.batch(i, 2, 16)}
    logs = []
    out = failure.run_restartable(
        loop.make_lm_train_step(cfg, ocfg), make_batch,
        (params, opt.adamw_init(params, ocfg)), n_steps=n_steps,
        ckpt_dir=str(tmp), ckpt_every=0, log_fn=logs.append)
    return out, logs


def test_preempted_and_resumed_run_is_bitwise_the_uninterrupted_one(
        tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    (want, last, pre), _ = _train(tmp_path / "straight", 4)
    assert (last, pre) == (4, False)
    (_, last, pre), logs = _train(tmp_path / "cut", 4, preempt_at=1)
    assert (last, pre) == (2, True)
    assert "[preempt] checkpointed at step 2" in logs
    assert ckpt.latest_step(str(tmp_path / "cut")) == 2
    (got, last, pre), logs = _train(tmp_path / "cut", 4)
    assert (last, pre) == (4, False) and "[restore] resumed from step 2" \
        in logs
    assert signal.getsignal(signal.SIGTERM) == before
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_straggler_monitor_flags_slow_steps():
    mon = failure.StragglerMonitor(window=8, threshold=2.0)
    flags = [mon.record(i, 0.1) for i in range(8)]
    assert not any(flags)
    assert mon.record(8, 0.35) and mon.flagged[0][:2] == (8, 0.35)
    assert not mon.record(9, 0.15)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mind"])
def test_train_launcher_runs_on_the_cpu(arch, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "2"], env=env, capture_output=True, text=True,
        timeout=300, check=True)
    assert "[train] step=0 loss=" in out.stdout
    assert f"done: step=3 preempted=False ckpt={tmp_path} on cpu" \
        in out.stdout
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_train_launcher_needs_a_card_unless_told_cpu(tmp_path):
    from repro_torch.launch import train
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "qwen3-0.6b", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])
    # the GNN archs are ported, and the launcher exits for them as the
    # reference's does (they train through the anchor-feature flow)
    with pytest.raises(SystemExit, match="gnn_sssp_features"):
        train.main(["--arch", "gatedgcn", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
