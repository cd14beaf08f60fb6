"""The one generator of traffic: a mix file (``bench/traffic/<mix>.json``)
holds its parameters, this module turns them into specs.

Keys of a mix:

* ``kind``: the ``SolveSpec`` kind; ``"tree"`` (the full shortest-path
  tree) is the one the reference judges today;
* ``sources_per_spec``: 1 gives scalar specs (``sssp``), more gives
  batched specs of that many sources (``sssp_batch``);
* ``sources``: ``"nonzero_degree_uniform"``, GAP's rule: uniform over the
  vertices of nonzero degree, without repeats, drawn from the seed;
* ``warmup_specs``: specs run before the window, from the
  highest-degree vertices (never timed, never drawn again);
* ``loop``/``clients``: ``"closed"`` with 1 client, the next spec sent
  when the last one's answer is back;
* ``check_specs``: how many of the window's specs the reference judges,
  drawn from the seed.
"""
import numpy as np
import torch

MAX_SPECS = 4096


def _check(traffic: dict) -> None:
    if traffic["kind"] != "tree":
        raise ValueError(f"traffic kind {traffic['kind']!r}: only 'tree' "
                         "is judged by the reference")
    if traffic["sources"] != "nonzero_degree_uniform":
        raise ValueError(f"unknown source draw {traffic['sources']!r}")
    if (traffic["loop"], int(traffic["clients"])) != ("closed", 1):
        raise ValueError("only a closed loop with one client is supported")


def plan(traffic: dict, deg: torch.Tensor, gen: torch.Generator):
    """``(warm, timed)``: the warm-up specs and the window's specs, each a
    list of source lists, on the host.  ``deg`` is the degree of every
    vertex; ``gen`` the run's generator on ``deg``'s device."""
    _check(traffic)
    per, n_warm = int(traffic["sources_per_spec"]), int(traffic["warmup_specs"])
    warm = torch.topk(deg, per * n_warm).indices
    ok = deg > 0
    ok[warm] = False
    cand = torch.nonzero(ok).flatten()
    cand = cand[torch.randperm(cand.shape[0], generator=gen,
                               device=cand.device)[:per * MAX_SPECS]]
    cand = cand[:cand.shape[0] // per * per].tolist()
    warm = warm.tolist()
    return ([warm[i:i + per] for i in range(0, len(warm), per)],
            [cand[i:i + per] for i in range(0, len(cand), per)])


def solve_spec(sources: list):
    """The ``SolveSpec`` of one spec's sources (scalar for one source)."""
    from repro_torch import SolveSpec
    return SolveSpec.tree(sources[0] if len(sources) == 1
                          else tuple(sources))


class Sample:
    """A uniform sample of ``k`` of the specs seen, drawn from ``seed``
    (reservoir sampling: at most ``k`` results held at a time)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 7])
        self.kept = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1
