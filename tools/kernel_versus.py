"""Time a port kernel against another build of its source, in turns, on the
card.

    python3 tools/kernel_versus.py matmul [--alt-source PATH]
    python3 tools/kernel_versus.py decode --alt-source PATH
    python3 tools/kernel_versus.py copy [--alt-source "PATH [-DNAME=V ...]"]...
    python3 tools/kernel_versus.py memset [--alt-source "PATH [-D...]"]...
    python3 tools/kernel_versus.py ssd [--alt-source PATH] [--arch ARCH]

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
rounds.  Both by CUDA events around back-to-back calls, after warm-up.

copy and memset: `chip_smoke.py`'s dma phase at its real sizes, and the
dense copy and memset at 1, 8, 32 and 128 MiB, by device time
(`torch.profiler`), 5 rounds in turns.  copy: the bf16 copy of gemma2-2b's
embedding table (256,000 x 2,304) on routes bulk and gather and
`x.clone()`, its cast to fp32 and `x.to(float32)`, mamba2-1.3b's SSD input
view through `strided_copy_nd` and `x.contiguous()`.  memset: a
(3,860,480, 256) bf16 zero fill and `torch.zeros`, the (16,384, 16,384)
int32 iota and `torch.arange`, the (256,000, 2,304) f32 prng.  First the
kernels that `x.clone()` (copy) and `torch.zeros` (memset) run, by name,
from the profiler.  Each --alt-source (repeatable) is a source built with
its -D flags in the port's source in place, on every route whose C entry
it exports: the parent's `copy_engine.cu` or `init_engine.cu`, or
`tools/dma_variants.cu`, the register-copy variants of the bulk copy and
of memset (-DVAR_RESERVE_BYTES=73728 -DVAR_UNROLL=4).

ssd: the prefill shape of `--arch`'s SSM (B 4, S 4,608; mamba2-1.3b, the
default: H 64, G 1, P 64, N 128, chunk 128; hymba-1.5b: H 50, N 16) in
fp32 and bf16, x, B and C as views of one (B, S, H·P + 2·G·N) tensor and
dt of a (B, S, H) one, as the SSM layer passes them: this
build on both routes (`ssd.ROUTES`) and, with --alt-source, that build of
`csrc/ssd.cu` through its own C entry `ssd_fwd` (the parent's kernel:
`git show 472b131:src/repro_torch/csrc/ssd.cu`), each checked against
`ssd_chunked_ref` (relative to max|plain|, 1e-4 fp32, 2e-2 bf16), then 5
rounds in turns by CUDA events; and the device time of each kernel the
tensor-core route launches, from the profiler.

Every output is checked against the plain version first.  Prints the
card's name and power limit, then one line per shape: median (min-max) ms
of each version.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import importlib
import shlex
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


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


def build(specs, name: str) -> list:
    """nvcc each of `specs` (a source, then any -D flags) as the port's
    runtime builds a kernel, headers from csrc/ and from the source's own
    directory, all at once; their libraries in order."""
    from repro_torch.kernels import runtime
    runtime.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for spec in specs:
        source, *flags = shlex.split(spec)
        tag = hashlib.sha1(spec.encode()).hexdigest()[:10]
        out = runtime.BUILD_DIR / f"lib{name}-versus-{tag}.so"
        jobs.append((out, subprocess.Popen(
            [runtime.cuda_tool("nvcc"), *runtime.NVCC_FLAGS, *flags,
             f"-I{runtime.CSRC}", "-o", str(out), source])))
    libs = []
    for out, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {out.name}")
        lib = ctypes.CDLL(str(out))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs.append(lib)
    return libs


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
        alt = build([alt_source], "matmul_dma")[0]
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
    alt = build([alt_source], "decode_attention")[0]
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


def versus(module: str, cases, alts, entries) -> None:
    """Each case (label, input, call(x, route), plain(x), library call or
    None, routes) on every route of this build, of each alternative build
    whose C entry for that route it exports (`entries`: route → entry
    name), and the library call; outputs checked bit for bit, then device
    time in turns."""
    import torch
    from chip_smoke import in_turns
    mod = importlib.import_module(module)
    ours = mod._lib
    libs = dict(zip(alts, build(alts, module.rsplit(".", 1)[1])))
    for lib in libs.values():
        for entry in set(entries.values()):
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = getattr(ours(),
                                                       entry).argtypes
                getattr(lib, entry).restype = ctypes.c_int

    def on(lib, fn):
        def call():
            mod._lib = lambda: lib
            try:
                return fn()
            finally:
                mod._lib = ours
        return call

    for label, x, kern, plain, library, routes in cases:
        fns = {f"this {r}": functools.partial(kern, x, r) for r in routes}
        for spec, lib in libs.items():
            fns.update({f"{spec} {r}": on(lib, functools.partial(kern, x, r))
                        for r in routes if hasattr(lib, entries[r])})
        want = plain(x)
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
                raise AssertionError(f"{label}: {name} != plain version")
            del got
        del want
        if library is not None:
            fns["library"] = functools.partial(library, x)
        turns = in_turns(fns, rounds=5)
        print(f"{label}: device ms, median (min-max) of 5 in turns | " +
              " | ".join(f"{n} {m:.4f} ({lo:.4f}-{hi:.4f})"
                         for n, (m, lo, hi) in turns.items()), flush=True)
        torch.cuda.empty_cache()


def copy(alts) -> None:
    import torch
    from repro_torch.core import instream
    from repro_torch.kernels.copy_engine import (copy_2d_ref,
                                                 strided_copy_nd_ref)
    ce = importlib.import_module("repro_torch.kernels.copy_engine."
                                 "copy_engine")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    table = torch.randn((256000, 2304), generator=gen, device=dev,
                        dtype=bf16)
    ssm = torch.randn((4, 4608, 4352), generator=gen, device=dev)[
        ..., :4096].reshape(4, 4608, 64, 64).transpose(1, 2)
    up = functools.partial(instream.cast, dtype=f32)
    library_kernels("x.clone() of (256000, 2304) bf16", table.clone)

    def dense(n):   # the table's first n bf16 values, as (n / 1024, 1024)
        return table.view(-1)[:n].view(-1, 1024)

    def cp(x, r):
        return ce.copy_2d_cuda(x, kernel_route=r)

    def clone(x):
        return x.clone()

    cases = [("copy bf16 (256000, 2304)", table, cp, copy_2d_ref, clone,
              ("bulk", "gather"))]
    cases += [(f"copy bf16 {tuple(dense(n).shape)}", dense(n), cp,
               copy_2d_ref, clone, ("bulk", "gather"))
              for n in (1 << 19, 1 << 22, 1 << 24, 1 << 26)]
    cases += [
        ("cast bf16 -> f32 (256000, 2304)", table,
         lambda x, r: ce.copy_2d_cuda(x, up, f32, kernel_route=r),
         lambda x: copy_2d_ref(x, up, f32), lambda x: x.to(f32),
         ("convert",)),
        ("strided_copy_nd f32 (4, 64, 4608, 64) of (4, 4608, 4352)", ssm,
         lambda x, r: ce.strided_copy_nd_cuda(x), strided_copy_nd_ref,
         lambda x: x.contiguous(), ("gather",))]
    versus("repro_torch.kernels.copy_engine.copy_engine", cases, alts,
           {"bulk": "copy_bulk", "gather": "copy_gather",
            "convert": "copy_convert"})


def library_kernels(label: str, fn) -> None:
    """The device kernels (or driver copies and sets) a library call runs,
    by name, with their device time, from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    runs = [f"{e.key} x{e.count}, {e.self_device_time_total / 1e3 / 5:.4f} "
            f"ms a call" for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"{label} runs on the card: " + ("; ".join(runs) or "nothing"),
          flush=True)


def memset(alts) -> None:
    import torch
    from repro_torch.kernels.init_engine import (iota_fill_ref, memset_ref,
                                                 prng_fill_ref)
    ie = importlib.import_module("repro_torch.kernels.init_engine."
                                 "init_engine")
    dev = torch.device("cuda")
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    kv, idx, start = (3860480, 256), (16384, 16384), 1 << 20
    library_kernels("torch.zeros(3860480, 256, bf16)",
                    lambda: torch.zeros(kv, dtype=bf16, device=dev))

    def zeros(shape):
        return (shape, lambda s, r: ie.memset_cuda(s, 0, bf16, dev),
                lambda s: memset_ref(s, 0, bf16, dev),
                lambda s: torch.zeros(s, dtype=bf16, device=dev),
                ("memset",))

    cases = [(f"memset 0 bf16 {s}", *zeros(s))
             for s in (kv, (2048, 256), (16384, 256), (65536, 256),
                       (262144, 256))]
    cases += [
        ("iota_fill int32 (16384, 16384)", idx,
         lambda s, r: ie.iota_fill_cuda(s, start, i32, dev),
         lambda s: iota_fill_ref(s, start, i32, dev),
         lambda s: torch.arange(start, start + s[0] * s[1], dtype=i32,
                                device=dev).view(s), ("iota",)),
        ("prng_fill f32 (256000, 2304)", (256000, 2304),
         lambda s, r: ie.prng_fill_cuda(s, 7, f32, dev),
         lambda s: prng_fill_ref(s, 7, f32, dev), None, ("prng",))]
    versus("repro_torch.kernels.init_engine.init_engine", cases, alts,
           {"memset": "init_memset",
            "iota": "init_iota", "prng": "init_prng"})


def ssd(alt_source, arch: str = "mamba2-1.3b") -> None:
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.ssd import ssd_chunked_ref
    from repro_torch.models.ssm import ssm_dims
    sk = importlib.import_module("repro_torch.kernels.ssd.ssd")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2)
    ours = sk._lib
    alt = None
    if alt_source:
        alt = build([alt_source], "ssd")[0]
        alt.ssd_fwd.argtypes = ours().ssd_fwd.argtypes
        alt.ssd_fwd.restype = ctypes.c_int

    def alt_call(args):
        sk._lib = lambda: alt
        try:
            return sk.ssd_cuda(*args, chunk=L, kernel_route="cuda_cores")
        finally:
            sk._lib = ours

    cfg = get(arch)
    _, H, P, G, N = ssm_dims(cfg)
    B, S, L = 4, 4608, cfg.ssm.chunk
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    for dtype in (torch.float32, torch.bfloat16):
        xbc = torch.randn((B, S, H * P + 2 * G * N), generator=gen,
                          device=dev)
        xbc[..., H * P:] *= 0.3
        xs, Bs, Cs = torch.split(xbc.to(dtype), [H * P, G * N, G * N],
                                 dim=-1)
        dt = 0.001 + 0.099 * torch.rand((B, S, H), generator=gen, device=dev)
        args = (xs.reshape(B, S, H, P).transpose(1, 2), dt.transpose(1, 2),
                -torch.arange(1, H + 1, device=dev, dtype=torch.float32),
                torch.ones(H, device=dev),
                *(t.reshape(B, S, G, N).transpose(1, 2) for t in (Bs, Cs)))
        fns = {f"this {r}": functools.partial(sk.ssd_cuda, *args, chunk=L,
                                              kernel_route=r)
               for r in sk.ROUTES}
        if alt is not None:
            fns["alt"] = functools.partial(alt_call, args)
        want_y, want_state = ssd_chunked_ref(*args, chunk=L,
                                             return_state=True)
        errs = []
        for name, fn in fns.items():
            y, state = fn()
            e = max(rel_err(y, want_y), rel_err(state, want_state))
            if not e < tol[dtype]:
                raise AssertionError(f"ssd {dtype} {name}: rel err {e:.2e}")
            errs.append(f"{name} {e:.1e}")
        del want_y, want_state, y, state
        label = f"ssd {str(dtype)[6:]} B{B} H{H} G{G} S{S} P{P} N{N} L{L}"
        print(f"{label}, the model's views: rel err {', '.join(errs)} | "
              f"ms, median (min-max) of 5 in turns | "
              + in_turns(fns, 5), flush=True)
        library_kernels(f"{label} on route tensor_cores",
                        fns["this tensor_cores"])
        del args, xbc, xs, Bs, Cs, dt
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel",
                    choices=("matmul", "decode", "copy", "memset", "ssd"))
    ap.add_argument("--alt-source", action="append", default=[])
    ap.add_argument("--arch", default="mamba2-1.3b",
                    help="ssd: the model whose SSM shape to time")
    args = ap.parse_args()
    if args.kernel == "decode" and not args.alt_source:
        ap.error("decode needs --alt-source")
    if args.kernel in ("matmul", "decode", "ssd") and \
            len(args.alt_source) > 1:
        ap.error(f"{args.kernel} takes one --alt-source")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_versus.py times kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.kernel in ("matmul", "decode", "ssd"):
        alt = args.alt_source[0] if args.alt_source else None
        if args.kernel == "ssd":
            ssd(alt, args.arch)
        else:
            {"matmul": matmul, "decode": decode}[args.kernel](alt)
    else:
        (copy if args.kernel == "copy" else memset)(args.alt_source)


if __name__ == "__main__":
    main()
