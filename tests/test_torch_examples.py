"""The five ported examples (``examples/torch/``) on the CPU.

Each script keeps the reference example's flow, arguments and printed
lines and adds ``--device`` (default ``cuda``).  Here each ``main`` runs
with ``--device cpu`` at its smallest arguments and must print the line
the reference's prints to show it worked; asked for the card on a host
without one, each fails (no fallback to the CPU).  ``chip_smoke.py``
phase 4e-e runs them on the card at their defaults.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"


def load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_the_cpu(capsys):
    assert load("quickstart").main(["--scale", "7", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "correctness vs Dijkstra oracle: OK" in out
    assert "Bellman-Ford baseline: " in out and "p2p " in out


def test_serving_demo_on_the_cpu(capsys, tmp_path):
    trace = tmp_path / "trace.json"
    assert load("serving_demo").main(["--scale", "6", "--queries", "12",
                                      "--device", "cpu", "--trace-out",
                                      str(trace)])
    out = capsys.readouterr().out
    assert "12 queries in " in out
    assert "traced solve on 'social': " in out and trace.stat().st_size > 0


def test_gnn_sssp_features_on_the_cpu(capsys):
    acc = load("gnn_sssp_features").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"final nearest-anchor accuracy: {acc:.3f}" in out
    assert acc > 0.5


def test_serve_lm_on_the_cpu(capsys):
    gen = load("serve_lm").main(["--batch", "2", "--prompt-len", "8",
                                 "--gen", "4", "--device", "cpu"])
    assert tuple(gen.shape) == (2, 4)
    assert "generated shape: (2, 4)" in capsys.readouterr().out


def test_train_lm_on_the_cpu(capsys, tmp_path):
    last = load("train_lm").main(["--steps", "3", "--batch", "2", "--seq",
                                  "16", "--device", "cpu", "--ckpt-dir",
                                  str(tmp_path)])
    assert last == 3
    assert "finished at step 3 (preempted=False)" in \
        capsys.readouterr().out


@pytest.mark.parametrize("name,argv", [
    ("quickstart", ["--scale", "6"]), ("serving_demo", ["--scale", "6"]),
    ("gnn_sssp_features", []), ("serve_lm", []), ("train_lm", [])])
def test_examples_need_the_card_unless_told_cpu(name, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main(argv)
