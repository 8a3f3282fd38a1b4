"""Tiny cells for the CPU tests: each real cell's files, at sizes a test
run can hold, with the cell's own limits."""

import copy

from portbench.harness import spec

REAL = {"ps": "resnet18.ps8x1024_int8", "lm": "gpt2s.f32_t1024", "lm_bf16": "gpt2s.bf16_t1024"}


def _set(flags, name, value):
    flags = list(flags)
    flags[flags.index(name) + 1] = str(value)
    return flags


def tiny_cell(kind: str, real: str = None) -> spec.Cell:
    """``kind`` ``ps``: ResNet18 at its widths, 3 workers of 2 images,
    2 kept, over 24 images; ``lm`` / ``lm_bf16``: a 2-layer LM of width 32
    over 97 tokens, 4 sequences of 16."""
    cell = copy.deepcopy(spec.find_cell(real or REAL[kind]))
    if kind == "ps":
        cell.config["dataset"]["images"] = 24
        flags = _set(_set(cell.traffic["flags"], "--num-workers", 3), "--batch-size", 2)
        cell.traffic["flags"] = _set(flags, "--num-aggregate", 2)
    else:
        cell.config.update(n_vocab=97, n_ctx=32, n_embd=32, n_head=2, n_layer=2,
                           port_flags=["--vocab-size", "97", "--dim", "32", "--depth", "2",
                                       "--heads", "2"])
        flags = _set(_set(cell.traffic["flags"], "--seq-len", 16), "--batch-size", 4)
        cell.traffic.update(flags=flags, pool_steps=8)
    return cell
