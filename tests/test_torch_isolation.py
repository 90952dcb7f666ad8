"""The port stands alone: every module of `repro_torch`, and
`chip_smoke.py`, import in a process whose import system refuses `jax` and
`repro`, as on the machine with the card, which has no JAX.  The serving
entry point, the front door, the MoE gather and the sanitizer's and the
verifier's CLIs also run there on the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKER = """
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"refused import of {name}")
        return None

for mod in [m for m in sys.modules if m.split(".")[0] in
            ("jax", "jaxlib", "repro")]:
    del sys.modules[mod]
sys.meta_path.insert(0, Refuse())
"""


def _run(body: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER + textwrap.dedent(body)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_blocker_refuses_jax():
    out = _run("""
        try:
            import jax  # noqa: F401
        except ImportError:
            print("refused")
    """)
    assert "refused" in out


def test_every_module_imports_without_jax_or_repro():
    out = _run("""
        import importlib, importlib.util, pkgutil
        import repro_torch
        names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        assert "repro_torch.configs.hymba_1_5b" in names
        assert "repro_torch.configs.qwen2_5_32b" in names
        for n in ("core.vm", "core.analytics", "models.moe",
                  "configs.qwen2_moe_a2_7b", "configs.mixtral_8x7b",
                  "sanitize", "sanitize.__main__", "sanitize.diagnostics",
                  "sanitize.hazards", "sanitize.planaudit",
                  "sanitize.speccheck", "dist", "dist.fabric",
                  "dist.collectives", "verify", "verify.__main__",
                  "verify.adversary", "verify.collective",
                  "verify.generator", "verify.harness", "verify.serve",
                  "verify.shrink", "verify.vm", "optim", "optim.adamw",
                  "optim.schedule", "train", "train.train_step",
                  "train.trainer", "data", "data.pipeline",
                  "dist.fault", "dist.checkpoint", "models.encdec",
                  "configs.seamless_m4t_large_v2", "launch.train",
                  "dist.sharding", "dist.pipeline_parallel",
                  "launch.mesh", "launch.specs", "launch.analysis",
                  "launch.hlo_cost", "launch.dryrun",
                  "launch.debug_collectives"):
            assert "repro_torch." + n in names, n
        for n in names:
            importlib.import_module(n)
        from repro_torch.dist.collectives import compressed_psum  # noqa
        from repro_torch.dist.pipeline_parallel import gpipe  # noqa
        from repro_torch.dist.sharding import hint, param_specs  # noqa
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      "chip_smoke.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        assert not any(m.split(".")[0] in ("jax", "repro")
                       for m in sys.modules)
        print(len(names))
    """)
    assert int(out.split()[-1]) >= 80


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-1.3b", "hymba-1.5b",
                                  "qwen2.5-32b", "internvl2-26b",
                                  "qwen2-moe-a2.7b", "mixtral-8x7b"])
def test_serve_entry_point_runs_on_cpu_without_jax(arch):
    out = _run(f"""
        import runpy
        sys.argv = ["serve", "--arch", "{arch}", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "70", "--new-tokens", "3"]
        runpy.run_module("repro_torch.launch.serve", run_name="__main__")
    """)
    assert '"new_tokens": 6' in out and f'"arch": "{arch}"' in out


def test_descriptor_plane_runs_without_jax():
    """The smoke test's host step of its dma phase (the port's NumPy
    descriptor plane: a register front-end gather, the presets' cycles)
    and the plain copy and Init ops run where JAX cannot be imported."""
    out = _run("""
        import importlib.util
        import numpy as np
        import torch
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        sys.path.insert(0, "src")
        engine = smoke.dma_plane()
        from repro_torch.core import (BackendOptions, InitPattern, Protocol,
                                      Transfer1D)
        from repro_torch.kernels.copy_engine import (copy_2d,
                                                     copy_2d_reference)
        from repro_torch.kernels.init_engine import prng_fill
        engine.submit(Transfer1D(0, 0, 4096, Protocol.INIT, Protocol.OBI,
                                 options=BackendOptions(
                                     init_pattern=InitPattern.PSEUDORANDOM,
                                     init_value=42)))
        words = prng_fill((8, 128), 42, torch.uint32, device="cpu")
        assert np.array_equal(words.view(torch.uint8).reshape(-1).numpy(),
                              engine.mem.spaces[Protocol.OBI][:4096])
        x = np.arange(512 * 1024, dtype=np.float32).reshape(512, 1024)
        assert np.array_equal(copy_2d(torch.from_numpy(x)).numpy(),
                              copy_2d_reference(x))
        assert not any(m.split(".")[0] in ("jax", "repro")
                       for m in sys.modules)
        print("plane ok")
    """)
    assert "plane ok" in out and "[dma] preset edge_ai" in out



def test_front_door_runs_without_jax():
    """The continuous-batching front door runs where JAX cannot be
    imported: `ServeFrontDoor` over `HashLM` serves two requests to
    completion and equals the sequential oracle, and over a `StepLM` of a
    reduced gemma2-2b on the CPU it serves them again."""
    out = _run("""
        import numpy as np
        from repro_torch.configs import get
        from repro_torch.configs.base import RunConfig, reduced
        from repro_torch.models import LM
        from repro_torch.serve import (HashLM, KVLayout, ServeFrontDoor,
                                       ServeRequest, StepLM,
                                       oracle_generate)
        lay = KVLayout(n_pages=16, page_size=4, n_kv_heads=2, head_dim=4)

        def serve(model):
            fd = ServeFrontDoor(model, lay, max_seq_len=24, max_running=2)
            reqs = [ServeRequest(rid=i, prompt=[3 + i, 5, 7], seed=i,
                                 max_new_tokens=4, temperature=0.8 * i)
                    for i in range(2)]
            for r in reqs:
                fd.submit(r)
            fd.run()
            return reqs

        hash_lm = HashLM(lay.row_bytes)
        for r in serve(hash_lm):
            assert r.output == oracle_generate(
                hash_lm, r.seed, r.prompt, 4, r.temperature)
        lm = LM(reduced(get("gemma2-2b")), RunConfig(dtype="float32"),
                device="cpu")
        step = StepLM(lm, max_len=32, row_bytes=lay.row_bytes)
        assert [len(r.output) for r in serve(step)] == [4, 4]
        assert not any(m.split(".")[0] in ("jax", "repro")
                       for m in sys.modules)
        print("front ok", step.decode_calls)
    """)
    assert "front ok" in out


def test_moe_dispatch_on_the_engine_runs_without_jax():
    """The MoE path and its descriptor-plane twin run where JAX cannot be
    imported: reduced qwen2-moe-a2.7b's routing at the real capacity
    factor, its dispatch buffer and the `IDMAEngine`'s gather of the same
    token bytes, equal byte for byte."""
    out = _run("""
        import dataclasses
        import numpy as np
        import torch
        from repro_torch.configs import get
        from repro_torch.configs.base import reduced
        from repro_torch.core.vm import expert_gather_on_engine
        from repro_torch.models import moe
        cfg = reduced(get("qwen2-moe-a2.7b"))
        mc = dataclasses.replace(cfg.moe, capacity_factor=1.25)
        g = torch.Generator().manual_seed(0)
        router = torch.randn(cfg.d_model, mc.n_experts, generator=g)
        x = torch.randn(64, cfg.d_model, generator=g)
        x[:40] = x[0]
        r = moe.route(router, x, mc)
        buf = moe.dispatch(x, r, mc.n_experts)
        rows = x.view(torch.uint8).numpy().reshape(64, -1)
        got = expert_gather_on_engine(rows, r.expert_idx.numpy(),
                                      mc.n_experts, r.capacity)
        assert np.array_equal(got, buf.view(torch.uint8).numpy().reshape(
            got.shape))
        assert not bool(r.keep.all())
        assert not any(m.split(".")[0] in ("jax", "repro")
                       for m in sys.modules)
        print("moe ok")
    """)
    assert "moe ok" in out


@pytest.mark.parametrize("argv", [
    ["repro_torch.sanitize", "--demo", "--corpus", "--fuzz-racy", "8"],
    ["repro_torch.verify", "--seeds", "4"]], ids=["sanitize", "verify"])
def test_correctness_clis_run_without_jax(argv):
    """``python -m repro_torch.sanitize --demo --corpus --fuzz-racy 8``
    and ``python -m repro_torch.verify --seeds 4`` exit 0 where JAX and
    the reference cannot be imported."""
    out = _run(f"""
        import runpy
        sys.argv = {argv!r}
        try:
            runpy.run_module(sys.argv[0], run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert not any(m.split(".")[0] in ("jax", "repro")
                       for m in sys.modules)
        print("cli ok")
    """)
    assert "cli ok" in out
    if argv[0] == "repro_torch.sanitize":
        assert "corpus: 0 hazardous" in out and "8/8 flagged" in out
    else:
        assert "0 divergence(s)" in out


@pytest.mark.parametrize("argv", [
    ["--steps", "4", "--seq-len", "16", "--batch", "2"],
    ["--arch", "mamba2-1.3b", "--steps", "5", "--seq-len", "16",
     "--batch", "2", "--ckpt", "CKPT", "--ckpt-every", "2",
     "--fault-policy", "continue"]])
def test_train_entry_point_runs_on_cpu_without_jax(argv, tmp_path):
    """`python -m repro_torch.launch.train --device cpu` trains the
    reduced config where JAX cannot be imported, and with `--ckpt`
    leaves complete checkpoints the port restores."""
    argv = [str(tmp_path) if a == "CKPT" else a for a in argv]
    out = _run(f"""
        import runpy
        sys.argv = ["train", "--device", "cpu"] + {argv!r}
        runpy.run_module("repro_torch.launch.train", run_name="__main__")
        from repro_torch.dist import checkpoint
        if "--ckpt" in sys.argv:
            print("latest", checkpoint.latest(sys.argv[
                sys.argv.index("--ckpt") + 1]).step)
        assert not any(m.split(".")[0] in ("jax", "repro")
                       for m in sys.modules)
    """)
    steps = argv[argv.index("--steps") + 1]
    assert f'"steps": {steps}' in out and '"first_loss"' in out
    if "--ckpt" in argv:
        assert "latest 4" in out


def test_encdec_serves_and_trains_without_jax():
    """The encoder-decoder's serving steps and a train step on the CPU
    where JAX cannot be imported."""
    out = _run("""
        import torch
        from repro_torch.configs import get
        from repro_torch.configs.base import RunConfig, reduced
        from repro_torch.models import EncDec, init_encdec_cache
        from repro_torch.serve import make_decode_step, make_prefill_step
        from repro_torch.train import init_train_state, make_train_step
        cfg = reduced(get("seamless-m4t-large-v2"))
        model = EncDec(cfg, RunConfig(dtype="float32"), device="cpu")
        frames = torch.randn(2, 8, cfg.d_model)
        cross = make_prefill_step(model)(frames)
        cache = init_encdec_cache(2, 4, cfg, torch.float32, device="cpu")
        step = make_decode_step(model)
        for pos in range(4):
            logits, cache = step(cache, cross,
                                 torch.zeros(2, 1, dtype=torch.long), pos)
        rcfg = RunConfig(kernels="xla", dtype="float32")
        state = init_train_state(0, cfg, rcfg, device="cpu")
        state, m = make_train_step(cfg, rcfg)(state, {
            "frames": frames,
            "tokens": torch.randint(0, cfg.vocab_size, (2, 16))})
        assert torch.isfinite(logits).all() and m["loss"] > 0
        print("encdec ok", int(state["step"]))
    """)
    assert "encdec ok 1" in out


def test_production_mesh_refuses_a_world_of_4(tmp_path):
    """Four gloo ranks where JAX cannot be imported: `make_production_mesh`
    refuses the world of 4 and names the 256 (one pod) or 512 (two pods)
    ranks it needs; `make_host_mesh(2, 2)` builds the (data, model) mesh
    and `compressed_psum` sums over its 'data' dim."""
    from test_torch_dist_mesh import spawn_ranks, wait_all

    outs = wait_all(spawn_ranks("""
        from repro_torch.dist.collectives import compressed_psum
        from repro_torch.launch.mesh import (make_host_mesh,
                                             make_production_mesh)
        for multi_pod in (False, True):
            try:
                make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            except ValueError as e:
                print("refused:", e)
        mesh = make_host_mesh(2, 2, "cpu")
        x = torch.full((4,), float(rank))
        got = compressed_psum(x, "data", mesh)
        print("names", mesh.mesh_dim_names, "sum", got.tolist())
        assert not any(m.split(".")[0] in ("jax", "repro")
                       for m in sys.modules)
    """, tmp_path, prelude=BLOCKER))
    for rank, out in enumerate(outs):
        assert "needs a world of 256 ranks; this process group has 4" in out
        assert "needs a world of 512 ranks; this process group has 4" in out
        assert "names ('data', 'model')" in out
        # ranks (0, 1) and (2, 3) share a 'model' coordinate: data pairs
        # are {0, 2} and {1, 3}
        want = 2.0 if rank % 2 == 0 else 4.0
        assert f"sum [{want}, {want}, {want}, {want}]" in out, out


def test_specs_build_every_cell_without_jax():
    """`python -m repro_torch.launch.specs --all` where `jax` cannot be
    imported: every cell of the ten archs on the fake (16, 16) mesh."""
    out = _run("""
        import runpy, sys
        sys.argv = ["specs", "--all"]
        try:
            runpy.run_module("repro_torch.launch.specs",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
    """)
    lines = [ln for ln in out.splitlines() if ln.startswith('{"cell"')]
    assert len(lines) == 33, out



def test_dry_run_and_debug_collectives_run_without_jax(tmp_path):
    """`python -m repro_torch.launch.dryrun` and `debug_collectives` on
    one cell of the fake (16, 16) mesh where `jax` cannot be imported:
    the JSON is written, the collectives listed."""
    out = _run(f"""
        import json, os, runpy, sys
        for argv in (["dryrun", "--arch", "gemma2-2b", "--shape",
                      "decode_32k", "--out", {str(tmp_path)!r}],
                     ["debug_collectives", "--arch", "gemma2-2b",
                      "--shape", "decode_32k", "--top", "3"]):
            sys.argv = argv
            try:
                runpy.run_module("repro_torch.launch." + argv[0],
                                 run_name="__main__")
            except SystemExit as e:
                assert not e.code, e.code
        with open(os.path.join({str(tmp_path)!r},
                               "gemma2-2b_decode_32k_pod1.json")) as f:
            print("FLOPS", json.load(f)["cost"]["flops"])
    """)
    assert "All 1 dry-run cells passed." in out
    assert "total weighted collective bytes/device" in out
    assert float(out.split("FLOPS")[-1]) > 0
