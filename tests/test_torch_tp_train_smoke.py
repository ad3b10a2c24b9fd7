"""chip_smoke.py's phase 58 (the tensor axis for training) rehearsed on the
CPU: tp_train_phase at a tiny config, the one-process SFTTrainer against
SFTTrainer(TrainConfig(mesh_tp=2)) in two spawned gloo processes. Its gate
(each step's loss and grad norm within MULTI_REL of one process) and both
controls (down_proj's all-reduce dropped, the vocab-parallel CE's sum of
exp not all-reduced) must hold as on the card; the flash kernels and the
launch counts need the card and are left out."""

import dataclasses

import numpy as np
import torch


def test_chip_smoke_tp_train_phase_on_cpu(capsys):
    import chip_smoke
    from vlaser_tpu_torch.core.config import tiny_vlm

    # an MLP wide enough that down_proj's partial sums carry the
    # residual stream at random_init_'s N(0, 0.02^2), as Vlaser-2B's do
    # (at tiny_llm's 64 x 128 the control moves the step by < 1e-2)
    cfg = tiny_vlm()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, vocab_size=1200, hidden_size=512, intermediate_size=2048,
        num_heads=4, num_kv_heads=2, head_dim=128))
    counts = chip_smoke.tp_train_phase(torch, np, torch.device("cpu"),
                                       "[cpu]", {}, rehearse=(cfg, 256))
    assert counts == {}  # no kernel launches on the CPU
    out = capsys.readouterr().out
    assert "phase 58 Vlaser-2B SFT over tensor 2" in out
    assert "heads a rank (2, 1)" in out
