"""The port's checkpoints (vlaser_tpu_torch/utils/checkpoint.py,
SFTTrainer(checkpoint_dir=...)) and its preemption guard
(utils/preemption.py), on the CPU at tiny_vlm with fp32 compute: the
contract of the JAX checkpoint module (save, latest_step, max_to_keep 3,
restore with the data state as JSON), and 2 steps + save + restore into a
fresh model and trainer + 2 steps equal to 4 uninterrupted steps bit for
bit (losses, grad norms, every parameter and AdamW moment, the step
counter)."""

import os
import signal

import numpy as np
import pytest
import torch

from vlaser_tpu_torch.core.config import tiny_vlm
from vlaser_tpu_torch.models.vlm import InternVLChatModel
from vlaser_tpu_torch.scripts.train_sft import random_init_
from vlaser_tpu_torch.train.trainer import SFTTrainer, TrainConfig
from vlaser_tpu_torch.utils.checkpoint import (latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)
from vlaser_tpu_torch.utils.preemption import PreemptionGuard

N = 40  # tokens a batch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    img = cfg.vision.image_size
    ids = rng.integers(1, 400, (1, N))
    ids[0, 1:1 + cfg.num_image_token] = cfg.img_context_token_id
    labels = ids.copy()
    labels[0, :8] = -100
    seg = np.ones((1, N), np.int32)
    seg[0, N // 2:] = 2
    return {"input_ids": ids, "labels": labels,
            "loss_weight": np.ones((1, N), np.float32), "seg_ids": seg,
            "pixel_values": rng.standard_normal((1, img, img, 3)).astype(
                np.float32),
            "image_flags": np.ones((1,), np.int32)}


def _trainer(seed, ckpt=None, **kw):
    model = InternVLChatModel(tiny_vlm(), compute_dtype=torch.float32,
                              device="cpu", attn_impl="reference")
    random_init_(model, torch.Generator().manual_seed(seed))
    return SFTTrainer(model, TrainConfig(learning_rate=1e-3, total_steps=4,
                                         log_every=1, checkpoint_dir=ckpt,
                                         **kw))


def _state(trainer):
    """{name: tensor} of every parameter and AdamW state entry."""
    out = {f"p/{n}": p.detach().clone()
           for n, p in trainer.model.named_parameters()}
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for p, s in trainer.step_fn.optimizer.state.items():
        for k, v in s.items():
            out[f"o/{names[id(p)]}/{k}"] = v.detach().clone()
    return out


def _losses(trainer, batches):
    out = []
    for b in batches:
        m = trainer.train(iter([b]))
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out


def test_two_steps_save_restore_two_steps_equal_four(tmp_path):
    cfg = tiny_vlm()
    batches = [_batch(cfg, 10 + i) for i in range(4)]
    whole = _trainer(0)
    want = _losses(whole, batches)
    first = _trainer(0, str(tmp_path), save_every=100)
    got = _losses(first, batches[:2])
    assert latest_step(str(tmp_path)) == 2  # each train call's final save
    second = _trainer(7)  # another init: the restore must overwrite it
    assert not torch.equal(second.model.mlp1.fc1.kernel,
                           first.model.mlp1.fc1.kernel)
    params = [id(p) for p in second.model.parameters()]
    assert restore_checkpoint(str(tmp_path), second.model,
                              second.step_fn) is None
    assert second.step == 2
    assert [id(p) for p in second.model.parameters()] == params
    got += _losses(second, batches[2:])
    assert got == want
    a, b = _state(whole), _state(second)
    assert sorted(a) == sorted(b) and len(a) > 100
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_save_latest_max_to_keep_and_data_state(tmp_path):
    trainer = _trainer(0)
    cfg = tiny_vlm()
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), trainer.model,
                           trainer.step_fn)
    for step in range(1, 6):
        trainer.train(iter([_batch(cfg, step)]))
        path = save_checkpoint(str(tmp_path), step, trainer.model,
                               trainer.step_fn, {"cursor": 10 * step,
                                                 "order": [3, 1]})
        assert os.path.basename(path) == str(step)
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5"]
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path / "5")) == [
        "meta.json", "optimizer.safetensors", "params.safetensors"]
    fresh = _trainer(3)
    assert restore_checkpoint(str(tmp_path), fresh.model, fresh.step_fn,
                              step=4) == {"cursor": 40, "order": [3, 1]}
    assert fresh.step == 4
    # a half-written step (no meta.json) is not a step
    os.makedirs(tmp_path / "9")
    assert latest_step(str(tmp_path)) == 5


def test_trainer_saves_every_n_on_preemption_and_at_the_end(tmp_path):
    cfg = tiny_vlm()
    cursor = iter(range(100))
    data_state = lambda: {"cursor": next(cursor)}
    t = _trainer(0, str(tmp_path / "a"), save_every=2)
    t.cfg.total_steps = 5
    t.train(iter([_batch(cfg, i) for i in range(9)]),
            data_state_fn=data_state)
    assert t.step == 5
    # saves at 2 and 4, the final one at 5; max_to_keep 3
    assert sorted(os.listdir(tmp_path / "a")) == ["2", "4", "5"]

    class Guard:
        def should_stop(self):
            return t2.step == 3

    t2 = _trainer(0, str(tmp_path / "b"), save_every=2)
    t2.train(iter([_batch(cfg, i) for i in range(4)]),
             preemption_guard=Guard())
    assert t2.step == 3 and sorted(os.listdir(tmp_path / "b")) == ["2", "3"]
    fresh = _trainer(1)
    restore_checkpoint(str(tmp_path / "a"), fresh.model, fresh.step_fn)
    assert fresh.step == 5
    with open(tmp_path / "a" / "5" / "meta.json") as f:
        assert '"cursor": 2' in f.read()


def test_restore_refuses_state_of_other_parameters(tmp_path):
    trainer = _trainer(0)
    trainer.train(iter([_batch(tiny_vlm(), 0)]))
    save_checkpoint(str(tmp_path), 1, trainer.model, trainer.step_fn)
    frozen_llm = _trainer(0, freeze_llm=True)  # its optimizer holds fewer
    with pytest.raises(KeyError, match="optimizer state"):
        restore_checkpoint(str(tmp_path), frozen_llm.model,
                           frozen_llm.step_fn)


def test_preemption_guard_catches_sigterm_and_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    seen = []
    signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with PreemptionGuard() as guard:
            assert not guard.should_stop()
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.triggered and guard.should_stop()
            assert seen == [signal.SIGTERM]  # the previous handler chained
        assert signal.getsignal(signal.SIGTERM) is not guard._handle
        g2 = PreemptionGuard()
        g2.request_stop()
        assert g2.should_stop()
    finally:
        signal.signal(signal.SIGTERM, before)
