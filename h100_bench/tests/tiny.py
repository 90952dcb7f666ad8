"""Small configurations, mixes and a benchmark around them, for the CPU
tests: the cells' files at a size a test run holds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path
from typing import Dict, Optional

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "h100_bench"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SOURCE = "internlm2-20b"
# logit_err of these sizes in bf16 against the float32 reference, seeds
# 0-7, every request of a batch checked: 0.0047-0.0099; the float8
# control 0.058-0.139
TEST_LIMIT = 0.03


def config(dtype: str = "bfloat16") -> Dict:
    """The dense configuration file at a small width and depth."""
    cfg = json.loads((HERE / "configs" / f"{SOURCE}.json").read_text())
    cfg.update(name="tiny-dense", dtype=dtype, num_hidden_layers=3,
               hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               head_dim=16, intermediate_size=128, vocab_size=300)
    return cfg


MIX = dict(loop="closed", batch=4,
           prompt_tokens=dict(law="loguniform", low=8, high=40),
           output_tokens=dict(law="uniform", low=4, high=10),
           hot_share=0.25, hot_temperature=0.8, max_len=56,
           check_requests=3, trace_decode_steps=3)


def bench_dir(tmp: Path, dtype: str = "bfloat16", mix: Dict = MIX,
              limit: float = TEST_LIMIT, cfg: Optional[Dict] = None,
              limits: Optional[Dict] = None):
    """A benchmark folder under `tmp` (the real metric readers, a small
    configuration, one mix, one limit) and its BENCHMARK.json, whose
    metrics are the real file's; returns (folder, spec, cell name).
    `cfg` and `limits` replace the small dense configuration and its
    `logit_err` limit."""
    shutil.copytree(HERE / "metrics", tmp / "metrics")
    for d in ("configs", "traffic", "limits"):
        (tmp / d).mkdir()
    cfg = cfg or config(dtype)
    name = f"{cfg['name']}.mix"
    (tmp / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (tmp / "traffic" / "mix.json").write_text(json.dumps(mix))
    (tmp / "limits" / f"{name}.json").write_text(
        json.dumps(limits or {"logit_err": limit}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [dict(name=name, config=cfg["name"], traffic="mix",
                              chips=1, why="test")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m["workloads"] = [name]
    return tmp, spec, name


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these models' ops are far too small for more,
    and the test run has a worker a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
