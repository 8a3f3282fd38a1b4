"""Autotune on the port, ResNet18: a small knob grid (the CLI default,
JAX's three engine-refused pipelined per-leaf points, the block-32
fused two-round wire PSC103 prunes, the 4 MiB bucketed int8 wire and
its homomorphic twin) searched by the port and by JAX's live ``run_search`` under JAX's
profile values passed explicitly: the same ranked candidates, the same
pruned set and best candidate, and the tuned config's modeled speedup
over the default meets ``GATE_MIN_SPEEDUP`` at that profile.
"""

import pytest

from ps_pytorch_tpu.tune import search as jsearch
from ps_pytorch_tpu_torch.tune import search
from tests.test_torch_tune import (  # noqa: F401
    _one_thread,
    jax_exact_jit,
    jax_profile,
    jax_walker_exact_jit,
    port_profile,
    search_summary,
)

M = 4 << 20


def small_grid(Knobs):
    return [
        Knobs(),
        Knobs(overlap="pipelined"),
        Knobs(compress="int8", overlap="pipelined"),
        Knobs(compress="int8_2round", overlap="pipelined"),
        Knobs(compress="int8_2round", bucket_bytes=0, quant_block_size=32),
        Knobs(compress="int8", bucket_bytes=M),
        Knobs(compress="int8", bucket_bytes=M, wire_domain="homomorphic"),
    ]


def test_torch_resnet18_search_equals_jaxs_and_meets_the_gate(monkeypatch):
    monkeypatch.setattr(jsearch, "build_grid", lambda model, grid: small_grid(jsearch.Knobs))
    monkeypatch.setattr(search, "build_grid", lambda model, grid: small_grid(search.Knobs))
    jprof = jax_profile("ResNet18")
    theirs = jsearch.run_search("resnet18", profile=jprof)
    mine = search.run_search("resnet18", profile=port_profile(jprof), device="cpu")
    assert search_summary(mine) == search_summary(theirs)
    config = [p for p in mine["pruned"] if p["stage"] == "config"]
    assert len(config) == 3 and all("pipelined" in p["reason"] for p in config)
    (contract,) = [p for p in mine["pruned"] if p["stage"] == "contract"]
    assert contract["name"] == "ps_resnet18_int8_2round_replicated_bucketed_qb32"
    assert contract["rules"] == ["PSC103"]
    gate = mine["gate"]
    assert gate["min_modeled_speedup"] == search.GATE_MIN_SPEEDUP["resnet18"] == 1.03
    assert gate["modeled_speedup"] >= gate["min_modeled_speedup"]
    assert mine["default"]["knobs"] == search.DEFAULT_KNOBS.to_json()
    assert mine["best"]["flag_line"].startswith("--network ResNet18 --dataset Cifar10")
    assert gate["modeled_speedup"] == pytest.approx(theirs["gate"]["modeled_speedup"], rel=0.01)
