"""Split the f32 kernels' time a key tile between their phases, on the card.

    python3 flash_phases.py

Copies this checkout's ``ray_tpu_torch/ops/csrc/flash_attention.cu``,
inserts ``clock64()`` probes into the f32 consumer's key-tile loop
(thread 0 of every consumer warpgroup: the wait for K's planes, S = Q K^T
in its batches, the two-CTA cluster's exchange of partial S past D =
128, the softmax, the split of P and the wait for V's planes, P V;
"loop" is the rest), builds the copy with the port's nvcc flags into
``build/variants/`` and runs the full-card rows of ``flash_tf32_kernel``
(B=2 T=4096; D=128, 256, 320 at H=16 and D=512 at H=8; causal and not).
Each row is one JSON line: cycles a key tile
and consumer warpgroup, summed over every CTA of one call and divided by
the key tiles they ran, beside the instrumented call's time (CUDA
events), after one line with the card's name and power limit.  The
probes are the only change; a missing anchor (the source moved) raises.
Needs a GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import sys

import chip_smoke as cs
import flash_routes as fr

REPS = 5                     # timed calls a row (instrumented_ms)
PHASES = ("loop", "wait_k_ready", "s_batches", "exchange", "softmax",
          "split_p_wait_v_ready", "p_v")
ROWS = [(2, 4096, h, d) for h, d in ((16, 128), (16, 256), (16, 320),
                                    (8, 512))]


def probe(i: int) -> str:
    return (f"    if (t == 0) {{ const long long c = clock64(); "
            f"prof[{i}] += c - tc; tc = c; }}\n")


FLUSH = ("    if (t == 0 && kt == n_kt - 1) {\n"
         "      for (int i = 0; i < 7; ++i)\n"
         "        atomicAdd(&g_phase[i], (unsigned long long)prof[i]);\n"
         "      atomicAdd(&g_phase[7], (unsigned long long)n_kt);\n"
         "    }\n")
# (anchor, text before it, text after it); each anchor occurs once
PROBES = [
    ("constexpr int kConverters = 96;  // producer warps 1-3 build the "
     "planes\n", "", "__device__ unsigned long long g_phase[8];\n"),
    ("  mbar_wait(bar32(bar0, kQFull, 0), 0);\n"
     "  for (int kt = 0; kt < n_kt; ++kt) {\n",
     "  long long prof[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  long long tc = clock64();\n", probe(0)),
    ("    mbar_wait(bar32(bar0, kKReady, s), par);\n", "", probe(1)),
    ("    mbar_arrive(bar32(bar0, kKFree, s));\n", "", probe(2)),
    ("    softmax32_tile<kBN>(", probe(3), ""),
    ("#pragma unroll\n    for (int i = 0; i < kBN / 2; ++i) {\n"
     "      ph[i] = tf32_hi(acc_s[i]);", probe(4), ""),
    ("    mbar_wait(bar32(bar0, kVReady, s), par);\n", "", probe(5)),
    ("    mbar_arrive(bar32(bar0, kVtFree, s));\n", "", probe(6) + FLUSH),
]
READER = '''
extern "C" int rt_phases(unsigned long long* out) {
  const cudaError_t err =
      cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 8);
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return (int)err;
}
'''


def instrumented(src: str, probes=PROBES) -> str:
    """``src`` with ``probes`` (flash attention's by default; each
    (anchor, text before it, text after it), the probes declaring
    ``g_phase``) and ``READER`` (``rt_phases``) added."""
    for anchor, before, after in probes:
        if src.count(anchor) != 1:
            raise RuntimeError(f"instrumented: anchor not found once: "
                               f"{anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    return src + READER


def main() -> int:
    import torch

    from ray_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("flash_phases: needs a GPU", file=sys.stderr)
        return 1
    smi = cs.phase_device()
    src = (_build._CSRC / _build.SOURCES["flash_attention"]).read_text()
    cu = _build.BUILD_DIR.parent / "flash_phases" / "flash_attention.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(instrumented(src))
    lib_path = _build.build_variants([(cu, ())])[0]
    call = fr.caller(lib_path)
    read = ctypes.CDLL(str(lib_path)).rt_phases
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 8)()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.emit({"nvidia_smi": smi})
    for b, t, h, d in ROWS:
        for causal in (False, True):
            q, k, v = (torch.randn((b, t, h, d), generator=gen,
                                   device="cuda") for _ in range(3))
            ms = cs.cuda_ms(lambda: call(q, k, v, causal), reps=REPS)
            read(buf)                       # discard the timed calls
            call(q, k, v, causal)
            torch.cuda.synchronize()
            if read(buf):
                raise RuntimeError("flash_phases: reading the probes failed")
            tiles = buf[7]
            cycles = {p: buf[i] / tiles for i, p in enumerate(PHASES)}
            total = sum(cycles.values())
            cs.emit({"shape": [b, t, h, d], "causal": causal,
                     "instrumented_ms": ms, "key_tiles": tiles,
                     "cycles_a_tile": cycles, "cycles_sum": total,
                     "share": {p: c / total for p, c in cycles.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
