"""The operation and byte counts against hand counts, and the readers'
arithmetic on a hand-made trace (CPU only)."""

import math

import pytest

from portbench.harness import costs, spec
from portbench.harness.capture import DeviceTrace, reduce_chrome_trace
from portbench.harness.readers import idle_share, roofline

RESNET = spec.find_cell("resnet18.ps8x1024_int8")
GPT2 = spec.find_cell("gpt2s.bf16_t1024")
H100 = costs.peaks("NVIDIA H100 80GB HBM3")


def test_resnet18_counts():
    ref = spec.reference_module(RESNET)
    # 0.556 GMAC an image forward (convolutions and the linear layer)
    assert ref.macs_per_sample(RESNET.config) == 555_422_720
    specs = ref.leaf_specs(RESNET.config)
    assert len(specs) == RESNET.config["param_leaves"] == 62
    assert sum(math.prod(s) for _, s, _ in specs) == RESNET.config["params"] == 11_173_962
    # 6 x MACs x 8,192 images: 27.30 TFLOP a step
    assert 6 * 555_422_720 * 8192 == pytest.approx(27.30e12, rel=1e-3)


def test_gpt2_small_counts():
    ref = spec.reference_module(GPT2)
    specs = ref.leaf_specs(GPT2.config)
    assert sum(math.prod(s) for _, s, _ in specs) == 124_337_664
    # 742 M matrix-product FLOPs a token (6 N), 52.3 / 49.5 TFLOP a step
    assert 6 * costs.lm_matmul_params(50257, 768, 12, 4) == 741_192_192
    per_1024 = costs.lm_train_flops_per_token(50257, 768, 12, 4, 1024)
    assert per_1024 * 65536 == pytest.approx(52.2856e12, rel=1e-5)
    assert per_1024 - 741_192_192 == 6 * 1024 * 768 * 12  # causal attention, fwd + bwd
    per_256 = costs.lm_train_flops_per_token(50257, 768, 12, 4, 256)
    assert per_256 * 65536 == pytest.approx(49.5025e12, rel=1e-5)


def test_k2_bound_is_the_byte_count_of_the_62_leaf_step():
    nbytes = costs.k2_bytes(8, 11_173_962, 62)
    assert nbytes == 8 * 11_173_962 * 5 + 62 * 4
    assert nbytes / H100["hbm_bytes_per_s"] * 1e3 == pytest.approx(0.13342, abs=5e-6)


def test_flash_counts_by_hand():
    b, h, t, d = 64, 12, 1024, 64
    ops, nbytes = costs.flash_fwd_cost(b, h, t, d, 2)
    assert ops == 2 * b * h * t * t * d  # QK^T and PV, half of each causal
    assert nbytes == 3 * b * t * h * d * 2 + b * t * h * d * 4 + 2 * b * h * t * 4
    ops, nbytes = costs.flash_bwd_cost(b, h, t, d, 2)
    assert ops == 4 * b * h * t * t * d  # four products, half of each causal
    assert nbytes == 4 * b * t * h * d * 2 + 2 * b * h * t * 4 + 3 * b * t * h * d * 4
    assert costs.flash_peak("float32", H100) == 165e12
    assert costs.lm_peak("float32", H100) == 67e12


def _trace():
    events = [
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 5.0, "dur": 10.0},  # overlaps
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 60.0, "dur": 40.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 40.0, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 3.0},
    ]
    return reduce_chrome_trace(events, steps=2)


def test_trace_reduction_busy_idle_and_gaps():
    t = _trace()
    assert t.launches == 1 and len(t.kernels) == 3 and len(t.device) == 4
    assert t.span_us() == 100.0
    assert t.busy_us() == 15.0 + 10.0 + 40.0
    assert idle_share(t) == pytest.approx(35.0)
    gaps = t.idle_gaps(2)
    assert gaps[0] == ["cudaMemcpyAsync", 20e-6] and gaps[1] == ["host", 15e-6]
    assert t.top_ops(1) == [["k_a", 50e-6]]


def test_roofline_share():
    t = _trace()
    # two k_a launches at a 20 us bound each, over 50 us of k_a
    assert roofline(t, ("k_a",), 20e-6) == pytest.approx(80.0)
    assert roofline(t, ("nothing",), 20e-6) is None


def test_a_capture_without_device_events_is_no_reading():
    with pytest.raises(RuntimeError, match="no device event"):
        reduce_chrome_trace([{"ph": "X", "cat": "cpu_op", "name": "x", "ts": 0, "dur": 1}], 1)


def test_readers_leave_out_what_they_cannot_read():
    t = DeviceTrace(device=[("k", 0.0, 1.0)], launches=1, runtime=[], steps=1)
    facts = {"cell": GPT2, "trace": t, "spans": [], "peak_window_bytes": 0,
             "device_kind": "NVIDIA H100 80GB HBM3",
             "work": {"batch": 64, "heads": 12, "seq": 1024, "head_dim": 64,
                      "dtype": "bfloat16"}}
    for name in ("flash_fwd_roofline.lm", "flash_bwd_roofline.lm", "gemm_device_ms.lm",
                 "dispatch_ms.lm", "peak_mem_gib.lm"):
        assert spec.metric_reader(name).read(facts) is None, name
    facts["device_kind"] = "some other card"
    assert spec.metric_reader("step_mfu.lm").read(facts) is None
