"""Which of the embedding_bag kernel's designs runs best at each batch, and
how it compares with another checkout's.

    python3 tools/embedding_bag_grid.py [--against DIR]

Builds copies of ``src/repro_torch/kernels/embedding_bag/csrc/
embedding_bag.cu`` (``COPIES``), one ``nvcc`` each, all at once, into
``build/embedding_bag_grid/``: the staged path at every batch
(``staged``), the direct path at every batch (``direct``), and the staged
path at every batch with each row copied by one ``cp.async.bulk``
completing on an mbarrier by byte count in place of 16-byte ``cp.async``
copies (``bulk``).  Each replaced text must occur in the source exactly
once, else the script stops, so an edit to the kernel shows here at once.
On MIND's 10^7 x 64 f32 table and the smoke's ``serve_p99`` and
``serve_bulk`` batches (``chip_smoke.recsys_inputs``) it times by
CUDA-graph replay (``chip_smoke.graph_ms``) both entries in sum mode (the
weighted one on ``bag_inputs``' ids and weights, the masked one on the
raw ids and mask) in turns: the kernel, each copy, each copy again in the
reverse order, the kernel again (:func:`design_times`).  Every copy's
output must equal the kernel's bit for bit.  With ``--against DIR`` (a
checkout of another commit) it also times, in turns, that checkout's
kernel and layer on the same inputs (``chip_smoke.measure_bag``).
Prints the card's name and power limit, then one ``[bag grid]`` JSON line
per shape (and ``[bag against]`` lines).  Needs one card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402

_STAGE = """\
      if (active)
        for (int i = 0; i < n; ++i)
          cp_async16(ring + i * p.pitch + t * 16,
                     table + list.off[i] + pass * p.pitch + t * 16);
      cp_async_wait_all();
"""
_BULK_STAGE = """\
      if (t == 0) {
        mbar_expect_tx(bar, n * parts * 16);
        for (int i = 0; i < n; ++i)
          bulk_copy(ring + i * p.pitch,
                    table + list.off[i] + pass * p.pitch, parts * 16, bar);
      }
      mbar_wait(bar, phase);
      phase ^= 1;
"""
_KERNEL = ("__global__ void __launch_bounds__(32) staged_kernel(const Params "
           "p) {\n")
# a group's mbarrier, one phase a listed segment
_BULK_SETUP = """\
  __shared__ uint64_t bars[32 / G];
  uint64_t* bar = &bars[threadIdx.x / G];
  int phase = 0;
  if (threadIdx.x % G == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(
                     smem_u32(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncwarp();
"""
_PATH = "  if (warps <= fit) {\n"
_BULK_HELPERS = """\
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\\n.reg .pred P1;\\nLAB_WAIT:\\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\\n"
      "@P1 bra.uni DONE;\\nbra.uni LAB_WAIT;\\nDONE:\\n}\\n" ::"r"(
          smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

"""
_HELPERS_AT = "// The staged path: one warp a block"

# name: [(text of the source, what takes its place), ...]
COPIES = {
    "staged": [(_PATH, "  if (true) {\n")],
    "direct": [(_PATH, "  if (false) {\n")],
    "bulk": [(_PATH, "  if (true) {\n"), (_STAGE, _BULK_STAGE),
             (_KERNEL, _KERNEL + _BULK_SETUP),
             (_HELPERS_AT, _BULK_HELPERS + _HELPERS_AT)],
}


def build_copies(names=None) -> dict:
    """``{name: library}`` for the named copies of ``COPIES`` (default:
    all), one ``nvcc`` each, all at once."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops
    path = _build.sources()["embedding_bag"]
    text = path.read_text()
    out = _build.BUILD_DIR.parent / "embedding_bag_grid"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in COPIES if names is None else names:
        copy = text
        for old, new in COPIES[name]:
            if copy.count(old) != 1:
                raise AssertionError(f"copy {name}: {old!r} is not in "
                                     f"{path.name} exactly once")
            copy = copy.replace(old, new)
        src = out / f"{name}.cu"
        src.write_text(copy)
        so = out / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for copy {name}:\n{log}")
        libs[name] = ops.bind(ctypes.CDLL(str(so)))
    return libs


def design_times(libs: dict, table, hist, mask) -> dict:
    """Graph ms of both entries (sum) with the kernel and each copy in
    ``libs`` in its place, in turns (the kernel, the copies, the copies
    reversed, the kernel); each copy's output must equal the kernel's bit
    for bit.  Returns ``{entry: {design: mean ms}}``."""
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models.recsys.embedding import bag_inputs
    kid, w = bag_inputs(table.shape[0], hist, mask)
    calls = {"weighted": lambda: ops.embedding_bag(table, kid, w),
             "masked": lambda: ops.embedding_bag_masked(table, hist, mask)}
    real = ops._library
    order = ["kernel", *libs, *reversed(libs), "kernel"]
    res = {}
    try:
        for entry, call in calls.items():
            want = call()
            times = {name: [] for name in order}
            for name in order:
                ops._library = real if name == "kernel" else \
                    (lambda lib=libs[name]: lib)
                if name != "kernel" and not chip_smoke.same_bits(call(),
                                                                 want):
                    raise AssertionError(f"embedding_bag {entry}: copy "
                                         f"{name} disagrees with the kernel")
                times[name].append(chip_smoke.graph_ms(call))
            res[entry] = {n: sum(t) / len(t) for n, t in times.items()}
    finally:
        ops._library = real
    return res


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="a checkout of another commit: time its "
                    "embedding_bag and layer in turns with this tree's")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("embedding_bag_grid: no CUDA device is available",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    device = torch.device("cuda")
    print(chip_smoke.card_line(), flush=True)
    _build.build_all(["embedding_bag"])
    libs = build_copies()
    if opts.against:
        chip_smoke.PARENT = chip_smoke.load_parent(opts.against)
    _, params, batches = chip_smoke.recsys_inputs(device)
    table = params["item_embed"]
    for shape, (hist, mask) in batches.items():
        print(f"[bag grid] {shape}: " + json.dumps(
            design_times(libs, table, hist, mask)), flush=True)
        if opts.against:
            print(f"[bag against] {shape}: " + json.dumps(
                chip_smoke.measure_bag(table, hist, mask)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
