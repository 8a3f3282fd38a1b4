"""Port parity: ps_pytorch_tpu_torch.tools.longcontext_check against the JAX
package's tools/longcontext_cpu_check.py and its committed record.

The port's tool runs at ``--seq 512 --devices 4 --device cpu`` (the
kernels' plain versions) and passes; its report has the keys of
``runs/longcontext_t8192_cpu.json`` (``kernels`` in place of
``pallas_interpret``). Its ring output and gradients of ``sum(o * w)`` on
the tool's own numpy inputs equal JAX's ring flash attention on the same
inputs (the Pallas kernels in interpret mode, on a 4-device sequence
mesh) within tests/test_torch_ring_attention.py's 2e-5 on values and 5e-5
on gradients.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ps_pytorch_tpu.parallel.ring_attention import make_ring_attention as j_make_ring
from ps_pytorch_tpu.parallel.ring_attention import make_seq_mesh as j_seq_mesh
from ps_pytorch_tpu.parallel.ring_attention import shard_sequence as j_shard
from ps_pytorch_tpu_torch.parallel import ring_attention as tra
from ps_pytorch_tpu_torch.tools import longcontext_check as lc
from tests.test_torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, DEVICES = 512, 4


@pytest.fixture(scope="module")
def port_run():
    return lc.run_check(seq=SEQ, dim=64, heads=1, devices=DEVICES, grad=True, device="cpu")


def test_torch_longcontext_check_passes_on_the_cpu(tmp_path):
    out = tmp_path / "rec.json"
    rep = lc.main(["--seq", str(SEQ), "--devices", str(DEVICES), "--device", "cpu",
                   "--out", str(out)])
    assert rep["all_pass"] and json.loads(out.read_text()) == rep
    assert rep["backend"] == "cpu" and rep["seq"] == SEQ and rep["devices"] == DEVICES
    # the plain versions run on the CPU: no kernel launches
    assert rep["kernels"] == {"flash_partial": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    with open(os.path.join(REPO, "runs", "longcontext_t8192_cpu.json")) as f:
        jax_rec = json.load(f)
    assert set(rep) == set(jax_rec) - {"pallas_interpret"} | {"kernels"}
    assert [c["what"].replace("4-way", "8-way") for c in rep["checks"]] == [
        c["what"] for c in jax_rec["checks"]]
    for got, want in zip(rep["checks"], jax_rec["checks"]):
        assert set(got) == set(want)


def test_torch_longcontext_check_runs_each_head_count(tmp_path):
    rep = lc.main(["--seq", "64", "--devices", "4", "--heads", "1", "2", "--no-grad",
                   "--device", "cpu"])
    assert rep["all_pass"] and [r["heads"] for r in rep["runs"]] == [1, 2]
    assert all(len(r["checks"]) == 1 and "grad_seconds" not in r for r in rep["runs"])


def test_torch_longcontext_check_fails_a_wrong_ring(monkeypatch):
    full = tra.full_attention
    monkeypatch.setattr(tra, "full_attention", lambda *a, **k: full(*a, **k) + 1e-3)
    rep, _ = lc.run_check(seq=64, dim=16, heads=1, devices=4, grad=True, device="cpu")
    assert not rep["all_pass"] and not rep["checks"][0]["pass"]


def test_torch_longcontext_check_needs_the_card_unless_told():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lc.main(["--seq", "64", "--devices", "4"])


def test_torch_longcontext_ring_matches_jax_ring_flash(port_run):
    rep, arrays = port_run
    assert rep["all_pass"]
    mesh = j_seq_mesh(DEVICES)
    ring = j_make_ring(mesh, causal=True, impl="flash")
    qs, ks, vs = (j_shard(jnp.asarray(arrays[n]), mesh) for n in "qkv")
    w = j_shard(jnp.asarray(arrays["w"]), mesh)

    def loss(q, k, v):
        return jnp.sum(ring(q, k, v) * w)

    want_o = np.asarray(ring(qs, ks, vs))
    want_g = jax.grad(loss, argnums=(0, 1, 2))(qs, ks, vs)
    np.testing.assert_allclose(arrays["o"], want_o, rtol=2e-5, atol=2e-5)
    for name, g in zip("qkv", want_g):
        np.testing.assert_allclose(arrays["d" + name], np.asarray(g), rtol=5e-5, atol=5e-5)
