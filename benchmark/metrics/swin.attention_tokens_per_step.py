"""Padded query tokens Swin UNETR's window attention takes a step: the
program's ``swin.attention_tokens`` counter (each block's tokens after the
pad to a multiple of its window, over the crops, counted once a forward,
not in a recompute) over the traced window's steps."""

from benchmark.harness.program_trace import counter_per_step


def read(run):
    return counter_per_step(run, "swin.attention_tokens") if run.kind == "train" else None
