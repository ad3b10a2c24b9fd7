"""chip_smoke.py's phase 59 (the stage axis for training) rehearsed on the
CPU: pp_train_phase at a tiny config, the plain LLM stack in this process
against the GPipe pipeline at stage 2 (4 microbatches, a stageify_rules
state) in two spawned gloo processes. Its gate (each step's loss and grad
norm within MULTI_REL of one process, on both ranks) and both controls
(the backward's transfers zeroed; every microbatch given microbatch 0's
segment ids) must hold as on the card; the flash and RMSNorm kernels and
the launch counts need the card and are left out."""

import dataclasses

import numpy as np
import torch


def test_chip_smoke_pp_train_phase_on_cpu(capsys):
    import chip_smoke
    from vlaser_tpu_torch.core.config import tiny_llm

    cfg = dataclasses.replace(tiny_llm(vocab_size=1200), num_layers=4)
    counts = chip_smoke.pp_train_phase(torch, np, torch.device("cpu"),
                                       "[cpu]", {}, rehearse=(cfg, 256))
    assert counts == {}  # no kernel launches on the CPU
    out = capsys.readouterr().out
    assert "phase 59 Vlaser-2B's LLM over stage 2 (4 layers" in out
    assert "2 a stage" in out
    assert "8 receives a rank" in out  # 4 microbatches, forward + backward


def test_pp_want_derives_the_full_depth_counts():
    """At full depth (28 layers, stage 2, 4 microbatches, remat) a rank
    launches, each step, flash fwd 112 and bwd 56, RMSNorm fwd 224 and
    bwd 112, the last stage the final norm's too."""
    import chip_smoke

    first = chip_smoke._pp_want(28, 2, 0, 4, 1)
    last = chip_smoke._pp_want(28, 2, 1, 4, 1)
    assert first == {"flash_attention_fwd": 112, "flash_attention_bwd": 56,
                     "_rms_fwd": 224, "_rms_bwd": 112}
    assert last == {"flash_attention_fwd": 112, "flash_attention_bwd": 56,
                    "_rms_fwd": 225, "_rms_bwd": 113}
