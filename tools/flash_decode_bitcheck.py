#!/usr/bin/env python
"""Hold ``flash_decode`` against an earlier build of its CUDA source on the
card: every decode case of ``chip_smoke.py`` phase 3 (``FD_CASES`` and the
main paths' shapes) in fp32, bf16 and fp16, the same inputs through both,
and whether the outputs agree bit for bit.  The earlier source is one
whose C entry point has no slot offset and no log-sum-exp pointer (the
interface before the grid's serve steps), e.g. the parent commit's:

    git show <commit>:src/repro_torch/kernels/csrc/flash_decode.cu > build/old_fd.cu
    python3 tools/flash_decode_bitcheck.py build/old_fd.cu

Builds it with ``kernels/build.py``'s ``nvcc`` flags into ``build/`` beside
the current kernels.  Needs one card; prints one line a call, the count of
bit-identical calls and the card's ``nvidia-smi`` name and power limit,
and exits non-zero if any call differs.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(old_source: str) -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke as C
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        print("flash_decode_bitcheck: no CUDA device", file=sys.stderr)
        return 2
    lib = os.path.join(ROOT, "build", "flash_decode_old.so")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, old_source],
                         capture_output=True, text=True)
    if out.returncode:
        print(out.stdout + out.stderr, file=sys.stderr)
        return 1
    old = ctypes.CDLL(lib).repro_flash_decode
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    old.argtypes = (P, P, P, P, P, I, I, I, I, I, I, LL, I, I, F, I, P)
    build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = C.FD_CASES + [C.FD_SERVE, C.FD_ZAMBA2, C.FD_QWEN3_MOE, C.FD_WHISPER,
                          C.FD_PALIGEMMA, C.FD_PALIGEMMA_RING]
    same = total = 0
    for case in cases:
        label, B, KV, G, S, hd, pos, window, softcap, ring, _ = case
        for dname, dt in C.kernel_dtypes().items():
            q, [(k, v)] = C.fd_inputs(case, dt, gen)
            new = ops.flash_decode(q, k, v, pos, window=window, softcap=softcap, ring=ring)
            n_split = ops.decode_splits(B * KV, S, ops._sm_count(q.device.index))
            part = torch.empty((B * KV, n_split, G, hd + 2), dtype=torch.float32,
                               device="cuda")
            got = torch.empty_like(q)
            err = old(q.data_ptr(), k.data_ptr(), v.data_ptr(), part.data_ptr(),
                      got.data_ptr(), B, KV, G, S, hd, n_split, pos, window, int(ring),
                      float(softcap), ops.DTYPE_CODES[dt],
                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{label} {dname}: the old kernel failed with {err}")
            torch.cuda.synchronize()
            eq = bool((new.float().view(torch.int32) == got.float().view(torch.int32)).all())
            same += eq
            total += 1
            print(f"{label:40s} {dname:9s} bit-identical: {eq}", flush=True)
    print(f"{same} of {total} calls bit-identical")
    print(C.smi_line())
    return 0 if same == total else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
