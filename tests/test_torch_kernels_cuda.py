"""The port's hand-written kernels on the card, against their plain
PyTorch versions (K1 quantize_rows and its shared-scale entry
quantize_rows_scaled, K2 quantize_tensor, K3 accumulate_rescale_int8, K4
flash_fwd), the serving engine on the card against the same engine on the
CPU, and the gradient wires on the card against the same wires on the CPU
(bit-exact: every op on them is elementwise or an exact integer sum).

Every test here needs a CUDA card and skips without one. This file
imports neither JAX nor the JAX package (the card's machine has no JAX),
so it runs there on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX's CPU mesh.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from ps_pytorch_tpu_torch.models import TransformerConfig, init_transformer
from ps_pytorch_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
from ps_pytorch_tpu_torch.ops.quantize import (
    accumulate_rescale_int8,
    accumulate_rescale_plain,
    quantize_int8,
    quantize_rows,
    quantize_rows_plain,
    quantize_rows_scaled,
    quantize_rows_scaled_plain,
    quantize_tensor,
    quantize_tensor_plain,
)
from ps_pytorch_tpu_torch.parallel import collectives
from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves, tree_map
from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
from ps_pytorch_tpu_torch.serve import Request, ServeConfig, ServingEngine


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest --noconftest -m cuda "
                    "tests/test_torch_kernels_cuda.py` on the H100")
    # f32 comparisons need full f32 matmuls on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nb,bs,dtype", [
    (1024, 64, torch.bfloat16),   # prefill write: max_prompt_len * heads rows
    (64, 64, torch.bfloat16),     # decode write: slots * heads rows
    (1001, 128, torch.float32),   # ragged row count
    (3, 33, torch.float32),       # row width not a multiple of 32
    (17, 500, torch.bfloat16),
])
def test_torch_quantize_rows_kernel_bit_exact_on_card(cuda_device, nb, bs, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(nb + bs)
    x = (torch.randn((nb, bs), generator=g, device=cuda_device) * 3).to(dtype)
    x[1] = 0.0
    before = quantize_rows.launches
    q, s = quantize_rows(x)
    qp, sp = quantize_rows_plain(x)
    torch.cuda.synchronize()
    assert quantize_rows.launches == before + 1
    assert torch.equal(q, qp)
    assert torch.equal(s, sp)


@pytest.mark.cuda
def test_torch_quantize_kernel_rounds_half_to_even_on_card(cuda_device):
    x = torch.full((8, 128), 0.5, device=cuda_device)
    x[0, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5])
    q, s = quantize_int8(x, block_size=128)
    assert q[0, :6].tolist() == [127, 2, -4, 0, 0, 2]
    assert float(s[0, 0]) == 1.0


def _halves(x: torch.Tensor) -> torch.Tensor:
    """Plant exact halves where absmax is 127 (inv == 1): round half to
    even decides them."""
    flat = x.view(-1)
    flat[:6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5])
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((8, 3, 3, 512, 512), torch.float32),  # largest ResNet18 leaf, 8 workers
    ((8, 512), torch.float32),             # a BN leaf
    ((8, 10), torch.float32),              # the dense bias
    ((8, 1001), torch.float32),            # ragged odd length
    ((7, 33), torch.bfloat16),
])
def test_torch_quantize_tensor_kernel_bit_exact_on_card(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g, device=cuda_device) * 3).to(dtype)
    if dtype == torch.float32:
        # absmax 127 -> inv 1: the planted halves land on .5 exactly
        x = _halves(x.clamp(-100, 100))
    before = quantize_tensor.launches
    q, s = quantize_tensor(x)
    qp, sp = quantize_tensor_plain(x)
    torch.cuda.synchronize()
    assert quantize_tensor.launches == before + 1
    assert q.shape == x.shape and q.dtype == torch.int8 and s.shape == ()
    assert torch.equal(q, qp) and torch.equal(s, sp)
    if dtype == torch.float32:
        assert q.view(-1)[:6].tolist() == [127, 2, -4, 0, 0, 2]


@pytest.mark.cuda
def test_torch_quantize_tensor_kernel_all_zero_and_offset_view(cuda_device):
    z = torch.zeros((8, 513), device=cuda_device)
    q, s = quantize_tensor(z)
    assert float(s) == 0.0 and not q.any()
    # an unaligned slice takes the scalar path of both launches
    x = torch.randn(4097, device=cuda_device)[1:]
    q, s = quantize_tensor(x)
    qp, sp = quantize_tensor_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("workers,nb,bs,dtype", [
    (8, 18432, 128, torch.float32),  # the largest ResNet18 leaf at block 128
    (8, 4, 128, torch.float32),
    (3, 5, 33, torch.float32),
    (2, 9, 64, torch.bfloat16),
])
def test_torch_quantize_rows_scaled_kernel_bit_exact_on_card(cuda_device, workers,
                                                            nb, bs, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(nb + bs)
    x = (torch.randn((workers * nb, bs), generator=g, device=cuda_device) * 3).to(dtype)
    x.view(workers, nb, bs)[:, 1] = 0.0  # a block all-zero on every worker
    if dtype == torch.float32:
        x[2] = 0.5
        x[2, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5])
    absmax = x.float().abs().reshape(workers, nb, bs).amax(dim=(0, 2))
    before = quantize_rows_scaled.launches
    q, s = quantize_rows_scaled(x, absmax)
    qp, sp = quantize_rows_scaled_plain(x, absmax)
    torch.cuda.synchronize()
    assert quantize_rows_scaled.launches == before + 1
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert float(s[1, 0]) == 0.0
    if dtype == torch.float32:
        assert q[2, :6].tolist() == [127, 2, -4, 0, 0, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d,dtype,causal,kw", [
    (1, 128, 8, 64, torch.bfloat16, True, {}),   # the serving prefill shape
    (1, 128, 8, 64, torch.float32, True, {}),
    (1, 100, 8, 64, torch.float32, True, {}),
    (2, 100, 4, 32, torch.float32, False, {}),
    (1, 200, 2, 128, torch.float32, True, {}),
    (1, 77, 3, 64, torch.float32, True, {"q_off": 5, "k_off": 30, "k_len": 60}),
])
def test_torch_flash_kernel_matches_plain_on_card(cuda_device, b, t, h, d,
                                                  dtype, causal, kw):
    g = torch.Generator(device=cuda_device).manual_seed(t + d)
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=cuda_device).to(dtype)
    q, k, v = (a.reshape(b, t, h, d) for a in qkv.split(h * d, dim=-1))
    before = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, causal=causal, **kw)
    op, lsep = flash_fwd_plain(q, k, v, causal, d ** -0.5, **kw)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    assert o.dtype == dtype and o.shape == (b, t, h, d)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(o.float(), op.float(), atol=2e-2, rtol=1e-2)
        torch.testing.assert_close(lse, lsep, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(o, op, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, lsep, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_torch_engine_on_card_matches_cpu_engine(cuda_device, int8):
    """The engine on the card (kernels) emits the tokens the same engine
    emits on the CPU (plain versions), and launches K4 once per block per
    prefill and K1 twice per block per prefill and per decode step."""
    cfg = TransformerConfig(vocab_size=97, dim=128, depth=2, heads=2,
                            max_seq_len=64, attention_impl="flash")
    params = init_transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    serve = ServeConfig(slots=3, max_len=48, max_prompt_len=12, kv_int8=int8)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, 97, p).astype(np.int32),
                    max_new_tokens=n)
            for i, (p, n) in enumerate([(5, 9), (1, 6), (12, 8), (7, 14)])]
    outs = {}
    for dev in ("cpu", cuda_device):
        engine = ServingEngine(cfg, params, serve, device=dev)
        engine.warmup()
        k4, k1 = flash_fwd.launches, quantize_rows.launches
        p0, d0 = engine.n_prefills, engine.n_decode_steps
        outs[str(dev)] = [c.tokens for c in
                          engine.decode_requests([dataclasses.replace(r) for r in reqs])]
        if dev != "cpu":
            prefills = engine.n_prefills - p0
            steps = engine.n_decode_steps - d0
            assert prefills == 3
            assert flash_fwd.launches - k4 == cfg.depth * prefills
            assert quantize_rows.launches - k1 == (
                2 * cfg.depth * (prefills + steps) if int8 else 0)
    assert outs["cpu"] == outs["cuda"]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [
    (8, 11173968),  # the ResNet18 fused stacked payload (16-byte path)
    (8, 1396746),   # one region of it (byte path: s % 16 != 0)
    (8, 130), (1, 1), (258, 4096), (1, 300), (8, 16), (3, 17),
])
def test_torch_accumulate_rescale_kernel_bit_exact_on_card(cuda_device, n, s):
    g = torch.Generator(device=cuda_device).manual_seed(n + s)
    recv = torch.randint(-127, 128, (n, s), generator=g, device=cuda_device,
                         dtype=torch.int32).to(torch.int8)
    recv[:, 0] = 127  # a full-scale column: acc = 127 n
    for d in (5.0, 8.0, float(n), torch.tensor(float(n), device=cuda_device)):
        before = accumulate_rescale_int8.launches
        out = accumulate_rescale_int8(recv, d)
        plain = accumulate_rescale_plain(recv, d)
        torch.cuda.synchronize()
        assert accumulate_rescale_int8.launches == before + 1
        assert out.dtype == torch.int8 and tuple(out.shape) == (s,)
        assert torch.equal(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 5, 6, 8, 16])
def test_torch_accumulate_rescale_kernel_every_accumulator_on_card(cuda_device, d):
    """Every accumulator value in [-127 d, 127 d] rounds to the exact
    rounded quotient (half to even), from an aligned and from an
    unaligned base pointer."""
    target = np.arange(-127 * d, 127 * d + 1)
    rows, rest = [], target.copy()
    for _ in range(d):
        rows.append(np.clip(rest, -127, 127))
        rest = rest - rows[-1]
    recv = torch.from_numpy(np.stack(rows).astype(np.int8)).to(cuda_device)
    exact = torch.from_numpy(np.clip(np.round(target / d), -127, 127).astype(np.int8))
    assert torch.equal(accumulate_rescale_int8(recv, float(d)).cpu(), exact)
    buf = torch.empty(recv.numel() + 1, dtype=torch.int8, device=cuda_device)
    shifted = buf[1:].view(recv.shape)  # contiguous, base address odd
    shifted.copy_(recv)
    assert torch.equal(accumulate_rescale_int8(shifted, float(d)).cpu(), exact)


def _grads(device):
    rng = np.random.RandomState(0)
    scale = np.exp(rng.randn(8, 1) * 2).astype(np.float32)

    def leaf(*shape):
        x = rng.randn(8, *shape).astype(np.float32)
        return torch.from_numpy(x * scale.reshape((8,) + (1,) * len(shape))).to(device)

    return {"conv": {"kernel": leaf(3, 3, 16, 32), "bias": leaf(32)},
            "dense": leaf(512, 10), "odd": leaf(301),
            "zero": torch.zeros((8, 9), device=device)}


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_bytes", [None, 0, 65536])
@pytest.mark.parametrize("block", [0, 128])
@pytest.mark.parametrize("compress,domain", [
    ("int8", "dequant"), ("int8", "homomorphic"),
    ("int8_2round", "dequant"), ("int8_2round", "homomorphic"),
])
def test_torch_wires_on_card_match_cpu(cuda_device, compress, domain, block, bucket_bytes):
    """The aggregate and the EF contribution on the card (the kernels)
    equal the same wire on the CPU (the plain versions), bit for bit."""
    perm = torch.tensor([3, 0, 6, 1, 5, 2, 7, 4])
    kw = dict(num_aggregate=5, perm=perm, compress=compress, quant_block_size=block,
              bucket_bytes=bucket_bytes, wire_domain=domain, flat_output=True,
              return_contribution=True)
    g = _grads("cpu")
    k3 = accumulate_rescale_int8.launches
    agg_gpu, c_gpu = collectives.aggregate_gradients(
        tree_map(lambda t: t.to(cuda_device), g), WorkerAxis(8), 8, **kw)
    agg_cpu, c_cpu = collectives.aggregate_gradients(g, WorkerAxis(8), 8, **kw)
    torch.cuda.synchronize()
    assert torch.equal(agg_gpu.cpu(), agg_cpu)
    for a, b in zip(tree_leaves(c_gpu), tree_leaves(c_cpu)):
        assert torch.equal(a.cpu(), b)
    pieces = 1 if bucket_bytes == 0 else (5 if bucket_bytes is None else None)
    if compress == "int8_2round" and domain == "homomorphic" and pieces:
        assert accumulate_rescale_int8.launches - k3 == pieces
