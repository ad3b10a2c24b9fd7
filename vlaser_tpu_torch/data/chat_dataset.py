"""JSONL conversation dataset, chat preprocessing and packing for VLM SFT
(a copy of vlaser_tpu/data/chat_dataset.py: numpy and the standard
library, PIL imported only where an image item is read).

Parity surface:
- preprocess_internvl2_5 (internvl/train/dataset.py:711-790): per-segment
  tokenization (`<|im_start|>role\\n...<|im_end|>\\n`), labels -100
  everywhere except assistant content (assistant header and trailing
  newline masked), <image> expanded to <img><IMG_CONTEXT>*N</img>
- LazySupervisedDataset (internvl_chat_finetune.py:269-698): lazy JSONL,
  image / multi-image / video / text items, dynamic tiling, blank-tile
  padding for text-only samples (image_flags 0; :581-622), retry on error
- len2weight token / sample / square loss reduction (:786-795)
- PackedDataset (dataset_packed.py:46-553): bin-packing into <=
  max_packed_tokens buffers that carries segment ids for the flash kernel
  and a resumable cursor.
The packer and `length_grouped_indices` draw from Python's `random` with
the JAX package's seeds, so both packages emit the same batches.
`use_native_loader` sends a JPEG through the C++ loader
(data/native_loader.py) instead of PIL.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..image.tiling import load_image_tiles
from ..tokenizer.conversation import (
    IMG_CONTEXT_TOKEN,
    IMG_END_TOKEN,
    IMG_START_TOKEN,
    get_conv_template,
)

IGNORE_TOKEN_ID = -100


def len2weight(x: int, loss_reduction: str) -> float:
    if x == 0:
        return 0.0
    if loss_reduction == "token":
        return 1.0
    if loss_reduction == "sample":
        return 1.0 / x
    if loss_reduction == "square":
        return 1.0 / (x**0.5)
    raise NotImplementedError(loss_reduction)


def preprocess_internvl2_5(
    conversations: List[Dict[str, str]],
    tokenizer,
    num_image_token_list: Sequence[int],
    template_name: str = "internvl2_5",
    text_only: bool = False,
):
    """-> (input_ids, labels) int32 arrays (unpadded)."""
    convs = list(conversations)
    if convs and convs[0]["from"] == "system":
        system_prompt = convs[0]["value"]
        convs = convs[1:]
    else:
        system_prompt = get_conv_template(template_name).system_message

    if not text_only:
        idx = 0
        expanded = []
        for c in convs:
            c = dict(c)
            if c["from"] == "human":
                n = c["value"].count("<image>")
                for _ in range(n):
                    if idx == len(num_image_token_list):
                        break
                    tokens = (
                        IMG_START_TOKEN
                        + IMG_CONTEXT_TOKEN * num_image_token_list[idx]
                        + IMG_END_TOKEN
                    )
                    c["value"] = c["value"].replace("<image>", tokens, 1)
                    idx += 1
            expanded.append(c)
        convs = expanded

    segments, roles = [], []
    if system_prompt is not None:
        segments.append(f"<|im_start|>system\n{system_prompt}<|im_end|>\n")
        roles.append("system")
    for c in convs:
        if c["from"] == "human":
            segments.append(f"<|im_start|>user\n{c['value']}<|im_end|>\n")
            roles.append("human")
        elif c["from"] == "gpt":
            segments.append(f"<|im_start|>assistant\n{c['value']}<|im_end|>\n")
            roles.append("gpt")
        else:
            raise NotImplementedError(c["from"])

    ignore_len = len(
        tokenizer("<|im_start|>assistant\n", add_special_tokens=False)["input_ids"]
    )
    ids_out, labels_out = [], []
    for role, seg in zip(roles, segments):
        ids = tokenizer(seg, add_special_tokens=False)["input_ids"]
        ids_out.extend(ids)
        if role == "gpt":
            lab = list(ids)
            lab[:ignore_len] = [IGNORE_TOKEN_ID] * ignore_len
            lab[-1:] = [IGNORE_TOKEN_ID]  # trailing '\n'
            labels_out.extend(lab)
        else:
            labels_out.extend([IGNORE_TOKEN_ID] * len(ids))
    return np.asarray(ids_out, np.int32), np.asarray(labels_out, np.int32)


def preprocess_mpt_family(
    conversations: List[Dict[str, str]],
    tokenizer,
    num_image_token_list: Sequence[int],
    template_name: str,
    text_only: bool = False,
    add_bos: bool = False,
):
    """Per-segment tokenization + assistant-only masking for the chatml/MPT
    template family: Hermes-2, internlm2-chat, phi3-chat.

    Parity surface: internvl/train/dataset.py preprocess_mpt(:418),
    preprocess_phi3(:512), preprocess_internlm(:621) — those retokenize
    turn-splits of the full prompt; segment-wise construction here yields the
    same strings with the same assistant-span supervision. add_bos: the
    internlm2-chat convention prepends <s> (dataset.py:621 comment in
    conversation.py:345-349)."""
    tpl = get_conv_template(template_name)
    convs = list(conversations)
    if convs and convs[0]["from"] == "system":
        tpl.system_message = convs[0]["value"]
        convs = convs[1:]

    if not text_only:
        idx = 0
        expanded = []
        for c in convs:
            c = dict(c)
            if c["from"] == "human":
                n = c["value"].count("<image>")
                for _ in range(n):
                    if idx == len(num_image_token_list):
                        break
                    tokens = (
                        IMG_START_TOKEN
                        + IMG_CONTEXT_TOKEN * num_image_token_list[idx]
                        + IMG_END_TOKEN
                    )
                    c["value"] = c["value"].replace("<image>", tokens, 1)
                    idx += 1
            expanded.append(c)
        convs = expanded

    segments: List[str] = []
    supervised: List[bool] = []  # whole-segment flag; role prefix masked below
    sys_str = tpl.system_template.format(system_message=tpl.system_message)
    segments.append(sys_str + tpl.sep)
    supervised.append(False)
    for c in convs:
        if c["from"] == "human":
            segments.append(tpl.roles[0] + c["value"] + tpl.sep)
            supervised.append(False)
        elif c["from"] == "gpt":
            segments.append(tpl.roles[1] + c["value"] + tpl.sep)
            supervised.append(True)
        else:
            raise NotImplementedError(c["from"])

    ids_out: List[int] = []
    labels_out: List[int] = []
    if add_bos and getattr(tokenizer, "bos_token_id", None) is not None:
        ids_out.append(tokenizer.bos_token_id)
        labels_out.append(IGNORE_TOKEN_ID)
    role_len = len(tokenizer(tpl.roles[1], add_special_tokens=False)["input_ids"])
    for seg, sup in zip(segments, supervised):
        ids = tokenizer(seg, add_special_tokens=False)["input_ids"]
        ids_out.extend(ids)
        if sup:
            lab = list(ids)
            lab[:role_len] = [IGNORE_TOKEN_ID] * role_len
            labels_out.extend(lab)
        else:
            labels_out.extend([IGNORE_TOKEN_ID] * len(ids))
    return np.asarray(ids_out, np.int32), np.asarray(labels_out, np.int32)


PREPROCESS_FUNCTIONS = {
    "internvl2_5": preprocess_internvl2_5,
    # chatml/MPT family dispatches through preprocess_mpt_family
    "Hermes-2": lambda convs, tok, ntl, template_name="Hermes-2", **kw:
        preprocess_mpt_family(convs, tok, ntl, template_name, **kw),
    "internlm2-chat": lambda convs, tok, ntl, template_name="internlm2-chat", **kw:
        preprocess_mpt_family(convs, tok, ntl, template_name, add_bos=True, **kw),
    "phi3-chat": lambda convs, tok, ntl, template_name="phi3-chat", **kw:
        preprocess_mpt_family(convs, tok, ntl, template_name, **kw),
}


@dataclass
class ChatDatasetConfig:
    jsonl_path: str
    image_root: str = ""
    template: str = "internvl2_5"
    num_image_token: int = 256
    image_size: int = 448
    max_dynamic_patch: int = 12
    min_dynamic_patch: int = 1
    use_thumbnail: bool = True
    dynamic_image_size: bool = True
    max_seq_length: int = 4096
    loss_reduction: str = "token"
    repeat_time: float = 1.0
    # the C++ JPEG worker pool (data/native_loader.py)
    use_native_loader: bool = False


class ConversationDataset:
    """Lazy JSONL conversation dataset (text / single- / multi-image)."""

    def __init__(self, cfg: ChatDatasetConfig, tokenizer):
        self.cfg = cfg
        self.tokenizer = tokenizer
        with open(cfg.jsonl_path) as f:
            self.lines = f.readlines()
        if cfg.repeat_time != 1.0:
            n = int(len(self.lines) * cfg.repeat_time)
            self.lines = (self.lines * int(np.ceil(cfg.repeat_time)))[:n]

    def __len__(self):
        return len(self.lines)

    def _preprocess(self, convs, num_image_token_list, text_only=False):
        """Template-dispatched chat preprocessing (dataset.py preprocess_*
        variants: internvl2_5 / Hermes-2 / internlm2-chat / phi3-chat)."""
        fn = PREPROCESS_FUNCTIONS.get(self.cfg.template)
        if fn is None:
            return preprocess_internvl2_5(
                convs, self.tokenizer, num_image_token_list, self.cfg.template,
                text_only=text_only,
            )
        return fn(convs, self.tokenizer, num_image_token_list,
                  text_only=text_only)

    def _load_tiles(self, image_paths: List[str]) -> np.ndarray:
        """Each image's dynamic tiles, concatenated. With use_native_loader
        a JPEG goes through the C++ loader (data/native_loader.py) and PIL
        is imported only for another format, so a JSONL of JPEGs loads on a
        machine without PIL."""
        cfg = self.cfg
        all_tiles = []
        # multi-image items cap tiles per image (finetune.py:475-523)
        max_num = max(1, cfg.max_dynamic_patch // max(1, len(image_paths)))
        for p in image_paths:
            full = os.path.join(cfg.image_root, p)
            if cfg.use_native_loader:
                from .native_loader import load_image_tiles_native

                tiles = load_image_tiles_native(
                    full, cfg.image_size, cfg.min_dynamic_patch, max_num,
                    use_thumbnail=cfg.use_thumbnail and cfg.dynamic_image_size,
                    dynamic=cfg.dynamic_image_size,
                )
                if tiles is not None:
                    all_tiles.append(tiles)
                    continue
            from PIL import Image

            img = Image.open(full).convert("RGB")
            tiles = load_image_tiles(
                img, cfg.image_size, cfg.min_dynamic_patch, max_num,
                use_thumbnail=cfg.use_thumbnail and cfg.dynamic_image_size,
                dynamic=cfg.dynamic_image_size,
            )
            all_tiles.append(tiles)
        return np.concatenate(all_tiles, axis=0)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        """Retry-on-error with random resample, like the reference's
        fault-tolerant __getitem__ (internvl_chat_finetune.py:641-679)."""
        for attempt in range(10):
            try:
                return self._get(i)
            except Exception:
                if attempt == 9:
                    raise
                i = random.Random(i + attempt).randrange(len(self.lines))
        raise RuntimeError("unreachable")

    def _load_video_frames(self, video: str, num_segments: int = 8) -> List[str]:
        """Video items: a directory of frame images sampled uniformly
        (finetune.py video_get_item:525 samples frames; decord is replaced by
        a frames-directory convention — extract offline with any tool)."""
        frame_dir = os.path.join(self.cfg.image_root, video)
        frames = sorted(
            f for f in os.listdir(frame_dir)
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        )
        idx = np.linspace(0, len(frames) - 1, min(num_segments, len(frames)))
        return [os.path.join(video, frames[int(i)]) for i in idx]

    def _get(self, i: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        item = json.loads(self.lines[i])
        convs = item["conversations"]
        if "video" in item and item["video"]:
            # expand one <video> into per-frame <image> turns (finetune.py:525)
            paths = self._load_video_frames(item["video"])
            convs = [dict(c) for c in convs]
            for c in convs:
                if c["from"] == "human" and "<video>" in c["value"]:
                    frames_txt = "\n".join(
                        f"Frame{j+1}: <image>" for j in range(len(paths))
                    )
                    c["value"] = c["value"].replace("<video>", frames_txt, 1)
            tiles = self._load_tiles_per_image(paths, max_num=1)
            ids, labels = self._preprocess(
                convs, [cfg.num_image_token] * len(paths)
            )
            flags = np.ones(len(tiles), np.int32)
            return self._finalize(ids, labels, tiles, flags)
        if "image" in item and item["image"]:
            paths = item["image"] if isinstance(item["image"], list) else [item["image"]]
            tiles = self._load_tiles(paths)
            ids, labels = self._preprocess(
                convs,
                [cfg.num_image_token * (len(tiles) if len(paths) == 1 else 1)]
                if len(paths) == 1
                else [cfg.num_image_token] * len(paths),
            )
            flags = np.ones(len(tiles), np.int32)
        else:
            # text-only: blank tile with flag 0 (finetune.py:581-622)
            ids, labels = self._preprocess(convs, [], text_only=True)
            tiles = np.zeros((1, cfg.image_size, cfg.image_size, 3), np.float32)
            flags = np.zeros(1, np.int32)
        return self._finalize(ids, labels, tiles, flags)

    def _load_tiles_per_image(self, paths: List[str], max_num: int) -> np.ndarray:
        from PIL import Image

        cfg = self.cfg
        tiles = []
        for p in paths:
            img = Image.open(os.path.join(cfg.image_root, p)).convert("RGB")
            tiles.append(
                load_image_tiles(img, cfg.image_size, 1, max_num,
                                 use_thumbnail=False, dynamic=max_num > 1)
            )
        return np.concatenate(tiles, axis=0)

    def _finalize(self, ids, labels, tiles, flags) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        ids = ids[: cfg.max_seq_length]
        labels = labels[: cfg.max_seq_length]
        n_target = int((labels != IGNORE_TOKEN_ID).sum())
        if n_target == 0:
            # all supervision truncated away — raise so __getitem__'s retry
            # resamples (reference behavior, internvl_chat_finetune.py:641-679
            # region: zero-target samples are rejected)
            raise ValueError(
                f"sample has no target tokens within max_seq_length="
                f"{cfg.max_seq_length}"
            )
        weight = len2weight(n_target, cfg.loss_reduction)
        loss_weight = np.where(labels != IGNORE_TOKEN_ID, weight, 0.0).astype(np.float32)
        return {
            "input_ids": ids,
            "labels": labels,
            "loss_weight": loss_weight,
            "pixel_values": tiles.astype(np.float32),
            "image_flags": flags,
        }


class ConcatDataset:
    """Concatenation of ConversationDatasets (multi-dataset SFT).

    The reference trains from a metafile of many weighted JSONL datasets
    (internvl_chat_finetune.py:701-783, build_datasets); weighting is
    expressed per-dataset via repeat_time (applied inside each dataset) and
    the concatenated order is shuffled by the packer/sampler.
    """

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, i: int):
        k = int(np.searchsorted(self.offsets, i, side="right") - 1)
        return self.datasets[k][i - int(self.offsets[k])]


def build_datasets(meta_path: str, tokenizer, base_cfg: ChatDatasetConfig):
    """Metafile (name -> {root, annotation, repeat_time, max_dynamic_patch})
    -> ConcatDataset, matching the reference's ds_collections json format
    (internvl_chat_finetune.py:701-783; shell scripts pass --meta_path)."""
    from dataclasses import replace

    with open(meta_path) as f:
        meta = json.load(f)
    datasets = []
    for name in sorted(meta):
        m = meta[name]
        cfg = replace(
            base_cfg,
            jsonl_path=m["annotation"],
            image_root=m.get("root", base_cfg.image_root),
            repeat_time=float(m.get("repeat_time", 1.0)),
            max_dynamic_patch=int(m.get("max_dynamic_patch",
                                        base_cfg.max_dynamic_patch)),
        )
        datasets.append(ConversationDataset(cfg, tokenizer))
    return ConcatDataset(datasets)


def _image_spans(ids: np.ndarray, img_start_id: int, img_end_id: int):
    """[(start_idx, end_idx_inclusive)] of <img>...</img> regions."""
    starts = np.where(ids == img_start_id)[0]
    ends = np.where(ids == img_end_id)[0]
    return list(zip(starts.tolist(), ends.tolist()))


def split_sample(
    s: Dict[str, np.ndarray],
    max_tokens: int,
    img_start_id: int,
    img_end_id: int,
    num_image_token: int,
    image_size: int = 448,
) -> List[Dict[str, np.ndarray]]:
    """Split an overlong sample at non-image boundaries.

    Parity: dataset_packed.py:253-295 (split_buffer/_image_is_splitted) — a
    split point may never fall inside an <img>...</img> span; each chunk
    carries exactly the pixel tiles whose spans it contains. Chunks restart
    positions and segments (the halves no longer attend to each other — same
    approximation as the reference). Returns [] when a single image span
    exceeds max_tokens (cannot split inside an image).
    """
    ids = s["input_ids"]
    n = len(ids)
    spans = _image_spans(ids, img_start_id, img_end_id)
    chunks: List[Dict[str, np.ndarray]] = []
    start, tile_ofs = 0, 0
    while start < n:
        end = min(start + max_tokens, n)
        if end < n:
            for a, b in spans:
                if a < end <= b:
                    end = a  # move the cut to just before the image
                    break
            if end <= start:
                return []  # one image span is itself > max_tokens
        k = 0
        for a, b in spans:
            if a >= start and b < end:
                k += (b - a - 1) // num_image_token
        if k > 0:
            tiles = s["pixel_values"][tile_ofs : tile_ofs + k]
            flags = s["image_flags"][tile_ofs : tile_ofs + k]
            tile_ofs += k
        else:
            # text-only chunk: blank tile with flag 0 (finetune.py:581-622)
            tiles = np.zeros((1, image_size, image_size, 3), np.float32)
            flags = np.zeros(1, np.int32)
        chunks.append({
            "input_ids": ids[start:end],
            "labels": s["labels"][start:end],
            "loss_weight": s["loss_weight"][start:end],
            "pixel_values": tiles,
            "image_flags": flags,
        })
        start = end
    return chunks


def pad_collate(
    samples: List[Dict[str, np.ndarray]], pad_token_id: int,
    pad_to: Optional[int] = None, pad_multiple: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """concat_pad_data_collator equivalent (patch/pad_data_collator.py:57-118):
    pad ids/labels/weights per-batch, concat pixel_values/image_flags.

    pad_multiple rounds the padded length up to a multiple (context
    parallelism shards the sequence dim over cp devices, so lengths must
    divide; scripts/train_sft.py --cp passes 2*cp for zigzag headroom)."""
    max_len = max(len(s["input_ids"]) for s in samples)
    if pad_to:
        max_len = min(pad_to, ((max_len + pad_to - 1) // pad_to) * pad_to) \
            if max_len <= pad_to else max_len
    if pad_multiple:
        max_len = ((max_len + pad_multiple - 1) // pad_multiple) * pad_multiple
    b = len(samples)
    ids = np.full((b, max_len), pad_token_id, np.int32)
    labels = np.full((b, max_len), IGNORE_TOKEN_ID, np.int32)
    weights = np.zeros((b, max_len), np.float32)
    seg = np.zeros((b, max_len), np.int32)
    for i, s in enumerate(samples):
        n = len(s["input_ids"])
        ids[i, :n] = s["input_ids"]
        labels[i, :n] = s["labels"]
        weights[i, :n] = s["loss_weight"]
        seg[i, :n] = 1
    return {
        "input_ids": ids,
        "labels": labels,
        "loss_weight": weights,
        "seg_ids": seg,
        "pixel_values": np.concatenate([s["pixel_values"] for s in samples], 0),
        "image_flags": np.concatenate([s["image_flags"] for s in samples], 0),
    }


class PackedDataset:
    """Buffered best-fit bin-packing into fixed [max_packed_tokens] buffers
    with segment ids; resumable via state_dict/load_state_dict
    (dataset_packed.py:142-152; buffer-list packing :210-232)."""

    def __init__(
        self,
        dataset,
        max_packed_tokens: int = 8192,
        max_images_per_pack: int = 24,
        pad_token_id: int = 0,
        shuffle_seed: Optional[int] = 0,
        img_start_id: Optional[int] = None,
        img_end_id: Optional[int] = None,
        num_image_token: int = 256,
        image_size: int = 448,
        max_buffer_size: int = 16,
    ):
        self.dataset = dataset
        self.max_packed_tokens = max_packed_tokens
        self.max_images_per_pack = max_images_per_pack
        self.max_buffer_size = max(1, max_buffer_size)
        self.pad_token_id = pad_token_id
        # overlong samples split at non-image boundaries when the image token
        # ids are known (dataset_packed.py:253-295); dropped otherwise
        self.img_start_id = img_start_id
        self.img_end_id = img_end_id
        self.num_image_token = num_image_token
        self.image_size = image_size
        self.cursor = 0
        order = list(range(len(dataset)))
        if shuffle_seed is not None:
            random.Random(shuffle_seed).shuffle(order)
        self.order = order

    def state_dict(self) -> Dict:
        return {"cursor": self.cursor}

    def load_state_dict(self, state: Dict):
        self.cursor = int(state["cursor"])

    def shard(self, num_shards: int, index: int) -> "PackedDataset":
        """Multi-host sharding: each process packs a disjoint slice of the
        sample order (dataset_packed.py worker sharding analogue)."""
        self.order = self.order[index::num_shards]
        return self

    def _pieces(self, s: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
        if len(s["input_ids"]) <= self.max_packed_tokens:
            return [s]
        if self.img_start_id is None or self.img_end_id is None:
            return []  # cannot locate image spans; drop
        return split_sample(
            s, self.max_packed_tokens, self.img_start_id, self.img_end_id,
            self.num_image_token, self.image_size,
        )

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Buffered best-fit packing: up to `max_buffer_size` open packs; a
        piece goes to the fullest pack it fits (tokens AND images), a new
        pack opens otherwise (evicting the fullest when the buffer is at
        capacity). Matches the reference's buffered packer in fill-rate
        intent (dataset_packed.py:210-232 first-fit over a buffer list) —
        best-fit-by-tokens packs at least as tight."""
        open_packs: List[List] = []  # [samples, tokens, images]

        def fullest() -> int:
            return max(range(len(open_packs)), key=lambda i: open_packs[i][1])

        while self.cursor < len(self.order):
            sample = self.dataset[self.order[self.cursor]]
            self.cursor += 1
            for s in self._pieces(sample):
                n = len(s["input_ids"])
                t = len(s["pixel_values"])
                best = -1
                for i, (_, bt, bi) in enumerate(open_packs):
                    if (
                        bt + n <= self.max_packed_tokens
                        and bi + t <= self.max_images_per_pack
                        and (best < 0 or bt > open_packs[best][1])
                    ):
                        best = i
                if best >= 0:
                    pack = open_packs[best]
                    pack[0].append(s)
                    pack[1] += n
                    pack[2] += t
                    if (
                        pack[1] >= self.max_packed_tokens
                        or pack[2] >= self.max_images_per_pack
                    ):
                        yield self._emit(pack[0])
                        open_packs.pop(best)
                else:
                    if len(open_packs) >= self.max_buffer_size:
                        i = fullest()
                        yield self._emit(open_packs[i][0])
                        open_packs.pop(i)
                    open_packs.append([[s], n, t])
        for pack in open_packs:
            yield self._emit(pack[0])

    def _emit(self, buf: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        L = self.max_packed_tokens
        ids = np.full((L,), self.pad_token_id, np.int32)
        labels = np.full((L,), IGNORE_TOKEN_ID, np.int32)
        weights = np.zeros((L,), np.float32)
        seg = np.zeros((L,), np.int32)
        pos = np.zeros((L,), np.int32)
        ofs = 0
        for k, s in enumerate(buf):
            n = len(s["input_ids"])
            ids[ofs : ofs + n] = s["input_ids"]
            labels[ofs : ofs + n] = s["labels"]
            weights[ofs : ofs + n] = s["loss_weight"]
            seg[ofs : ofs + n] = k + 1
            pos[ofs : ofs + n] = np.arange(n)
            ofs += n
        return {
            "input_ids": ids[None],
            "labels": labels[None],
            "loss_weight": weights[None],
            "seg_ids": seg[None],
            "positions": pos[None],
            "pixel_values": np.concatenate([s["pixel_values"] for s in buf], 0),
            "image_flags": np.concatenate([s["image_flags"] for s in buf], 0),
        }


def estimate_lengths(dataset) -> List[int]:
    """Cheap per-sample token-length estimates for length grouping:
    conversation characters / 4 + image-token budget. See
    tokenized_lengths() for the reference-exact variant."""
    out = []
    for raw in getattr(dataset, "lines", []):
        item = json.loads(raw)
        n_chars = sum(len(c["value"]) for c in item["conversations"])
        n = n_chars // 4
        if item.get("image") or item.get("video"):
            n += getattr(dataset.cfg, "num_image_token", 256) * 4
        out.append(max(n, 1))
    return out


def tokenized_lengths(dataset) -> List[int]:
    """Reference-exact length computation for group-by-length
    (internvl_chat_finetune.py:361-382): a precomputed 'length' field wins;
    otherwise tokenize the joined conversation text (memoized by string
    length, like the reference's conv2length cache) and add
    num_image_token * (max_dynamic_patch + use_thumbnail)."""
    cfg = dataset.cfg
    tok = dataset.tokenizer
    img_budget = cfg.num_image_token * (
        cfg.max_dynamic_patch + int(cfg.use_thumbnail)
    )
    conv2length: Dict[int, int] = {}
    out = []
    for raw in getattr(dataset, "lines", []):
        item = json.loads(raw)
        if "length" in item:
            out.append(int(item["length"]))
            continue
        text = "\n".join(c["value"] for c in item["conversations"])
        key = len(text)
        if key not in conv2length:
            n = len(tok(text, add_special_tokens=False)["input_ids"])
            conv2length[key] = n + img_budget
        out.append(conv2length[key])
    return out


def length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    mega_batch_mult: int = 50,
    seed: int = 0,
) -> List[int]:
    """HF LengthGroupedSampler order (patch/train_sampler_patch.py:54-125):
    shuffle, split into megabatches of batch_size*mega_batch_mult, sort each
    by length desc, and swap the globally-longest sample into position 0 so
    the first step surfaces OOM immediately."""
    rng = random.Random(seed)
    idx = list(range(len(lengths)))
    rng.shuffle(idx)
    mb = batch_size * mega_batch_mult
    megabatches = [idx[i : i + mb] for i in range(0, len(idx), mb)]
    megabatches = [
        sorted(m, key=lambda i: lengths[i], reverse=True) for m in megabatches
    ]
    if megabatches:
        longest_mb = max(
            range(len(megabatches)), key=lambda i: lengths[megabatches[i][0]]
        )
        megabatches[0][0], megabatches[longest_mb][0] = (
            megabatches[longest_mb][0], megabatches[0][0],
        )
    return [i for m in megabatches for i in m]
