#!/usr/bin/env python3
"""Where a step of kernel 5 (``csrc/decoder_loop.cu``) spends its cycles.

    python3 tools/decoder_phase_clock.py

Builds a copy of the kernel with a ``clock64()`` mark after every phase
helper call, exchange and barrier of the step loop (CTA 0, thread 0, step
100), runs it at B=1 L=96 (C=16) and B=32 L=192 (C=2), 200 bf16 steps on
``chip_smoke.py``'s inputs, and prints the SM cycles from each mark to the
next with the source line that ends the span.  Needs a CUDA device.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
MARKED = re.compile(r"(run_jobs<T>\(|energy_partials|cluster_softmax|broadcast\(|"
                    r"cluster_(sync|arrive)\(|__syncthreads\(\))")
LOOP = "  for (int t = 0; t < a.n_steps; ++t) {"


def instrument(src):
    """(source with marks, the label of each span in order of the marks)."""
    head, rest = src.split(LOOP, 1)
    loop, tail = rest.split("\n}\n", 1)
    out, labels, layer = [], [], None
    for line in loop.split("\n"):
        out.append(line)
        code = line.split("//")[0].strip()
        if "for (int i = 0; i < NL; ++i)" in code:
            layer = len(labels)
        if code.startswith("run_jobs<T>(0, plan(P_L0 + 2 * NL)") and layer is not None:
            labels[layer:] = labels[layer:] * 2           # two decoder layers
            layer = None
        if MARKED.search(code) and code.endswith(";"):
            out.append("    CLK();")
            labels.append(code[:70])
    marks = ("__device__ long long g_clk[256];\n"
             "#define CLK() do { if (blockIdx.x == 0 && threadIdx.x == 0 && t == 100) "
             "g_clk[clk_n] = clock64(); ++clk_n; } while (0)\n")
    head = head.replace('#include "cluster_common.cuh"\n',
                        '#include "cluster_common.cuh"\n' + marks)
    body = (LOOP + "\n    int clk_n = 1;\n"
            "    if (blockIdx.x == 0 && threadIdx.x == 0 && t == 100) g_clk[0] = clock64();"
            + "\n".join(out))
    reader = ('\nextern "C" int read_clk(long long* h) '
              '{ return int(cudaMemcpyFromSymbol(h, g_clk, sizeof(g_clk))); }\n')
    return head + body + "\n}\n" + tail + reader, labels


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import cuda_build
    from tacotron_multispeaker_torch.ops import decoder_loop as dl
    if not torch.cuda.is_available():
        print("decoder_phase_clock: no CUDA device", file=sys.stderr)
        return 1
    d = tempfile.mkdtemp()
    for f in os.listdir(cuda_build.CSRC):
        shutil.copy(cuda_build.CSRC / f, d)
    src, labels = instrument((cuda_build.CSRC / "decoder_loop.cu").read_text())
    open(os.path.join(d, "decoder_loop.cu"), "w").write(src)
    so = os.path.join(d, "decoder_loop.so")
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so,
                           os.path.join(d, "decoder_loop.cu")], capture_output=True, text=True)
    if proc.returncode:
        print(proc.stderr[-3000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    lib.decoder_loop_launch.argtypes = [ctypes.c_void_p] * 3
    lib.decoder_loop_max_clusters.argtypes = [ctypes.c_void_p] * 2
    lib._typed = True
    dl._lib = lambda: lib
    for B, L, C in ((1, 96, 16), (32, 192, 2)):
        args = c._decoder_case(B, L, 200, torch.bfloat16, scale=0.05, seed=6)
        ms = c.cuda_time_ms(lambda: dl._decoder_loop_cuda(*args, cluster=C), reps=3)
        clk = (ctypes.c_longlong * 256)()
        torch.cuda.synchronize()
        lib.read_clk(clk)
        n = len(labels)
        print(f"B={B} L={L} C={C}: {ms:.3f} ms; step 100: {clk[n] - clk[0]} cycles")
        for i, label in enumerate(labels):
            print(f"  {clk[i + 1] - clk[i]:7d}  {label}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
