"""Time a port kernel against another build of its source, in turns, on the
card (CUDA events around back-to-back calls, after warm-up).

    python3 tools/kernel_versus.py matmul [--alt-source PATH]
    python3 tools/kernel_versus.py decode --alt-source PATH

matmul: the served models' bf16 GEMM shapes (gemma2-2b's FFN gate with its
tanh-gelu and its FFN down, mamba2-1.3b's in_proj, over 4 x 4,608 prefill
tokens; gemma2-2b's decode unembed through `table.t()` into fp32), on every
route `matmul_dma.routes` allows and `torch.matmul`, and with --alt-source
on the wgmma route of that build of `csrc/matmul_dma.cu` (the same C entry),
3 rounds.  decode: gemma2-2b's decode shape (B 4, Hq 8, Hkv 4, a 4,640-row
cache, D 256, bf16, softcap 50) at kv_len 4,608, 4,097, 17 and 1, this
build against --alt-source, a build of `csrc/decode_attention.cu` with the
C entry of the port's first slices (one block per (b, kv head), no key
splits: `git show 5a2c425:src/repro_torch/csrc/decode_attention.cu`), 5
rounds.  Every output is checked against the plain version first.  Prints
the card's name and power limit, then one line per shape: median (min-max)
ms of each version.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, rounds: int) -> str:
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(time_ms(fns[name]))
    return " | ".join(f"{n} {statistics.median(t):.4f} ({min(t):.4f}-"
                      f"{max(t):.4f})" for n, t in times.items())


def rel_err(got, want) -> float:
    import torch
    torch.cuda.synchronize()
    return float((got.float() - want.float()).abs().max() /
                 want.float().abs().max())


def build(source: str, name: str) -> ctypes.CDLL:
    """nvcc `source` as the port's runtime builds a kernel, headers from
    csrc/ and from the source's own directory."""
    from repro_torch.kernels import runtime
    out = runtime.BUILD_DIR / f"lib{name}-versus.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([runtime.cuda_tool("nvcc"), *runtime.NVCC_FLAGS,
                    f"-I{runtime.CSRC}", "-o", str(out), source], check=True)
    lib = ctypes.CDLL(str(out))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def matmul(alt_source) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.matmul_dma import matmul_ref
    mm = importlib.import_module("repro_torch.kernels.matmul_dma.matmul_dma")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(5)
    ours = mm._lib
    alt = None
    if alt_source:
        alt = build(alt_source, "matmul_dma")
        alt.matmul_fwd.argtypes = ours().matmul_fwd.argtypes
        alt.matmul_fwd.restype = ctypes.c_int

    def alt_call(x, w, out, epi):
        mm._lib = lambda: alt
        try:
            return mm.matmul_cuda(x, w, out, epi, kernel_route="wgmma")
        finally:
            mm._lib = ours

    T = 4 * 4608
    gelu = functools.partial(F.gelu, approximate="tanh")
    for label, (M, K, N), out, epi, k_major in (
            ("gate+gelu", (T, 2304, 9216), None, gelu, False),
            ("down", (T, 9216, 2304), None, None, False),
            ("in_proj", (T, 2048, 8512), None, None, False),
            ("unembed", (4, 2304, 256000), torch.float32, None, True)):
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((N, K) if k_major else (K, N), generator=gen,
                         device=dev) * K ** -0.5).to(torch.bfloat16)
        w = w.t() if k_major else w
        want = matmul_ref(x, w, out, epi)
        fns = {r: functools.partial(mm.matmul_cuda, x, w, out, epi,
                                    kernel_route=r) for r in mm.routes(x, w)}
        if alt is not None:
            fns["alt wgmma"] = functools.partial(alt_call, x, w, out, epi)
        errs = ", ".join(f"{n} {rel_err(f(), want):.1e}"
                         for n, f in fns.items())
        fns["torch.matmul"] = (
            lambda: torch.mm(x, w, out_dtype=out)) if out is not None else (
            lambda: epi(torch.matmul(x, w)) if epi else torch.matmul(x, w))
        print(f"{label} ({M}, {K}) @ ({K}, {N}): rel err {errs} | ms "
              + in_turns(fns, 3), flush=True)
        del x, w, want
        torch.cuda.empty_cache()


def decode(alt_source) -> None:
    import torch
    from repro_torch.kernels.decode_attention import decode_attention_ref
    da = importlib.import_module(
        "repro_torch.kernels.decode_attention.decode_attention")
    alt = build(alt_source, "decode_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    alt.decode_attention_fwd.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I,
                                         I, ctypes.c_float, ctypes.c_float, P]
    alt.decode_attention_fwd.restype = I
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    B, Hq, Hkv, S, D, cap, scale = 4, 8, 4, 4640, 256, 50.0, 1 / 16
    q = torch.randn((B, Hq, D), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((B, Hkv, S, D), generator=gen, device=dev).bfloat16()
            for _ in range(2))

    def alt_call(n, w):
        out = torch.empty_like(q)
        err = alt.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            n, B, Hq, Hkv, S, D, 1, w, scale, cap,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(alt.repro_cuda_error_string(err).decode())
        return out

    for n, w in ((4608, 0), (4608, 4096), (4097, 0), (17, 0), (1, 0)):
        kw = dict(kv_len=n, window=w, softcap=cap, scale=scale)
        fns = {"this": functools.partial(da.decode_attention_cuda, q, k, v,
                                         **kw),
               "alt": functools.partial(alt_call, n, w)}
        want = decode_attention_ref(q, k, v, **kw)
        errs = ", ".join(f"{n_} {rel_err(f(), want):.1e}"
                         for n_, f in fns.items())
        print(f"decode kv_len {n} w{w}: rel err {errs} | ms "
              + in_turns(fns, 5), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel", choices=("matmul", "decode"))
    ap.add_argument("--alt-source")
    args = ap.parse_args()
    if args.kernel == "decode" and not args.alt_source:
        ap.error("decode needs --alt-source")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_versus.py times kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    (matmul if args.kernel == "matmul" else decode)(args.alt_source)


if __name__ == "__main__":
    main()
