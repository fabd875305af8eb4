"""SAM3 text/box-prompted segmentation backend: prompt state, sessions
and the segmenter.

The port of ``trex_tpu/detect/sam3.py`` (the reference's
python/SAM3.{h,cpp}, SAM3PromptState.{h,cpp}, SAM3InteractiveSession.cpp,
trex_sam3_interface.py): frame-indexed prompt lists (text / boxes /
points, positive + negative) with the reference's string format,
prompt-state materialization for a frame (latest seed at or before the
frame wins, per object id), the interactive session state machine
(idle -> prompted -> propagating -> ready) and the anchor/replay
scheduler, all host code with the JAX package's semantics.

:class:`SamSegmenter` runs ``models/sam.py``'s SAM on the card (the CPU
when the caller names it): the image encoder and the mask decoder run on
the segmenter's device and each frame's chosen masks come back to the
host as one tensor. Its three OpenCV resizes are the port's own
(``track/tag_image.py``'s ``resize_linear``: the image's 8-bit
``INTER_LINEAR``, the masks' float32 one).
"""
from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class Sam3Prompt:
    """One prompt: free text, a box (x0,y0,x1,y1), or a point."""
    text: Optional[str] = None
    box: Optional[tuple] = None
    point: Optional[tuple] = None
    positive: bool = True

    def to_json(self) -> dict:
        out: dict = {"positive": self.positive}
        if self.text is not None:
            out["text"] = self.text
        if self.box is not None:
            out["box"] = list(self.box)
        if self.point is not None:
            out["point"] = list(self.point)
        return out

    @classmethod
    def from_json(cls, d: dict) -> "Sam3Prompt":
        return cls(text=d.get("text"),
                   box=tuple(d["box"]) if d.get("box") else None,
                   point=tuple(d["point"]) if d.get("point") else None,
                   positive=bool(d.get("positive", True)))


@dataclass
class Sam3PromptObject:
    """A tracked prompt object seeded at a frame (Sam3PromptObjectRef)."""
    id: int
    seed_frame: int
    seed_box: Optional[tuple] = None
    positive_prompts: list = field(default_factory=list)
    negative_prompts: list = field(default_factory=list)


class Sam3PromptPayload:
    """One prompt payload: text, point array, or box array
    (misc/Sam3PromptPayload; string format pinned by the reference's
    test_sam3promptpayload.cpp, ported in tests/test_sam3.py).

    type: 'none' | 'text' | 'points' | 'boxes'."""

    def __init__(self, value=None):
        if value is None or value == "" or value == []:
            self.type, self.value = "none", None
        elif isinstance(value, str):
            self.type, self.value = "text", value
        else:
            rows = [list(map(float, r)) for r in value]
            if all(len(r) == 2 for r in rows):
                self.type, self.value = "points", rows
            elif all(len(r) == 4 for r in rows):
                self.type, self.value = "boxes", rows
            else:
                raise ValueError("mixed prompt array shapes")

    def has_value(self) -> bool:
        return self.type != "none"

    def text(self):
        return self.value if self.type == "text" else None

    def points(self):
        return self.value if self.type == "points" else []

    def boxes(self):
        return self.value if self.type == "boxes" else []

    @classmethod
    def from_str(cls, sv: str) -> "Sam3PromptPayload":
        s = str(sv).strip()
        if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
            s = s[1:-1].strip()
        if not s:
            return cls(None)
        if s.startswith("["):
            rows = json.loads(s.replace("'", '"'))
            if not rows:
                return cls(None)
            return cls(rows)
        return cls(s)

    @staticmethod
    def _fmt(v: float) -> str:
        return str(int(v)) if float(v) == int(v) else repr(float(v))

    def to_str(self) -> str:
        if self.type == "none":
            raise ValueError("empty prompt payload has no string form")
        if self.type == "text":
            return self.value
        return "[" + ",".join(
            "[" + ",".join(self._fmt(x) for x in row) + "]"
            for row in self.value) + "]"

    def to_json(self):
        if self.type == "none":
            raise ValueError("empty prompt payload has no json form")
        if self.type == "text":
            return self.value
        return [[int(x) if float(x) == int(x) else float(x) for x in r]
                for r in self.value]

    def __eq__(self, other):
        return (isinstance(other, Sam3PromptPayload)
                and self.type == other.type and self.value == other.value)

    __str__ = to_str


class Sam3PromptList(list):
    """Ordered payload list; toStr collapses a single payload
    (test_sam3promptpayload.cpp:105-139)."""

    @classmethod
    def from_str(cls, sv: str) -> "Sam3PromptList":
        s = str(sv).strip()
        if not s.startswith("["):
            return cls([Sam3PromptPayload.from_str(s)])
        parts = _split_top_level(s[1:-1])
        if not parts:
            return cls()
        # a bare point/box array is ONE payload, not a list of rows
        if all(p.strip().startswith("[") for p in parts):
            try:
                return cls([Sam3PromptPayload.from_str(s)])
            except ValueError:
                pass
        return cls(Sam3PromptPayload.from_str(p) for p in parts)

    def to_str(self) -> str:
        if len(self) == 1:
            return self[0].to_str()
        return "[" + ",".join(p.to_str() for p in self) + "]"

    def to_json(self):
        return [p.to_json() for p in self]


def _split_top_level(s: str) -> list[str]:
    parts, depth, cur, quote = [], 0, [], None
    for ch in s:
        if quote:
            if ch == quote:
                quote = None
            cur.append(ch)
            continue
        if ch in "'\"":
            quote = ch
            cur.append(ch)
        elif ch == "[":
            depth += 1
            cur.append(ch)
        elif ch == "]":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        parts.append(tail)
    return parts


def parse_prompt_map(sv) -> dict:
    """Sam3Prompts::fromStr: '{0:fish,null:human}' or a bare payload /
    payload list (keyed null). Keys: int frame or None."""
    s = str(sv).strip()
    out: dict = {}
    if not s:
        return out
    if s.startswith("{"):
        for part in _split_top_level(s[1:-1]):
            if not part:
                continue
            k, _, v = part.partition(":")
            k = k.strip().strip('"').strip("'")
            key = None if k in ("null", "None", "") else int(k)
            out[key] = Sam3PromptList.from_str(v.strip())
        return out
    out[None] = Sam3PromptList.from_str(s)
    return out


def prompt_map_to_str(pmap: dict) -> str:
    if not pmap:
        return "{}"
    if len(pmap) == 1 and None in pmap:
        return pmap[None].to_str()
    def key(k):
        return "null" if k is None else str(k)
    items = sorted(pmap.items(),
                   key=lambda kv: (-1 if kv[0] is None else kv[0]))
    return "{" + ",".join(f"{key(k)}:{v.to_str()}" for k, v in items) + "}"


def prompt_map_to_json(pmap: dict) -> dict:
    return {("null" if k is None else str(k)): v.to_json()
            for k, v in sorted(
                pmap.items(),
                key=lambda kv: (-1 if kv[0] is None else kv[0]))}


def materialize_prompt_state(frame: int, pmap: dict):
    """materialize_sam3_prompt_state: shared (text/point) prompts from
    every entry at or before `frame`, plus one OBJECT per box — a
    legacy multi-box payload becomes separate single-box objects
    (test_sam3promptpayload.cpp:228-252)."""
    shared: list[Sam3PromptPayload] = []
    objects: list[Sam3PromptPayload] = []
    keys = sorted((k for k in pmap if k is None or k <= frame),
                  key=lambda k: (-1 if k is None else k))
    for k in keys:
        for payload in pmap[k]:
            if payload.type == "boxes":
                for box in payload.boxes():
                    objects.append(Sam3PromptPayload([box]))
            elif payload.has_value():
                shared.append(payload)
    return shared, objects


def flatten_prompt_state(state) -> list:
    shared, objects = state
    return list(shared) + list(objects)


class Sam3Prompts:
    """Frame-indexed prompt map (detect_sam3_prompt setting)."""

    def __init__(self):
        self.by_frame: dict[int, list[Sam3PromptObject]] = {}
        self._next_id = 1

    def add(self, frame: int, prompt: Sam3Prompt,
            box: Optional[tuple] = None) -> Sam3PromptObject:
        obj = Sam3PromptObject(id=self._next_id, seed_frame=frame,
                               seed_box=box)
        (obj.positive_prompts if prompt.positive
         else obj.negative_prompts).append(prompt)
        self._next_id += 1
        self.by_frame.setdefault(frame, []).append(obj)
        return obj

    def erase_object(self, object_id: int) -> bool:
        """erase_sam3_prompt_object."""
        for frame, objs in list(self.by_frame.items()):
            kept = [o for o in objs if o.id != object_id]
            if len(kept) != len(objs):
                if kept:
                    self.by_frame[frame] = kept
                else:
                    del self.by_frame[frame]
                return True
        return False

    def materialize(self, frame: int) -> list[Sam3PromptObject]:
        """materialize_sam3_prompt_state: the prompt objects active at
        `frame` — per object id, the newest seed at or before `frame`."""
        active: dict[int, Sam3PromptObject] = {}
        for f in sorted(self.by_frame):
            if f > frame:
                break
            for obj in self.by_frame[f]:
                active[obj.id] = obj
        return list(active.values())

    def flatten(self, frame: int) -> list[Sam3Prompt]:
        """flatten_sam3_prompt_state."""
        out = []
        for obj in self.materialize(frame):
            out.extend(obj.positive_prompts)
            out.extend(obj.negative_prompts)
        return out

    # -- (de)serialization to the settings JSON format -----------------
    def to_json(self) -> str:
        return json.dumps({
            str(f): [
                {
                    "id": o.id,
                    "seed_box": list(o.seed_box) if o.seed_box else None,
                    "positive": [p.to_json() for p in o.positive_prompts],
                    "negative": [p.to_json() for p in o.negative_prompts],
                }
                for o in objs
            ]
            for f, objs in self.by_frame.items()
        })

    @classmethod
    def from_setting(cls, value) -> "Sam3Prompts":
        """Accept either the reference's prompt-map string format
        ('fish', '{0:[[10,20,30,40]]}', ...) or our repository JSON."""
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            s = value.strip()
            looks_like_repo = False
            if s.startswith("{"):
                try:
                    data = json.loads(s)
                    looks_like_repo = data and all(
                        isinstance(v, list) and v
                        and isinstance(v[0], dict) and "id" in v[0]
                        for v in data.values())
                except (ValueError, AttributeError):
                    looks_like_repo = False
            if not looks_like_repo:
                pmap = parse_prompt_map(s)
                self = cls()
                for key, plist in pmap.items():
                    frame = 0 if key is None else int(key)
                    for payload in plist:
                        if payload.type == "text":
                            self.add(frame, Sam3Prompt(text=payload.text()))
                        elif payload.type == "points":
                            for pt in payload.points():
                                self.add(frame,
                                         Sam3Prompt(point=tuple(pt)))
                        elif payload.type == "boxes":
                            # one object per box (legacy multi-box)
                            for b in payload.boxes():
                                self.add(frame,
                                         Sam3Prompt(box=tuple(b)),
                                         box=tuple(b))
                return self
        return cls.from_json(value)

    @classmethod
    def from_json(cls, text) -> "Sam3Prompts":
        data = json.loads(text) if isinstance(text, str) else text
        self = cls()
        for f, objs in data.items():
            for o in objs:
                obj = Sam3PromptObject(
                    id=int(o["id"]), seed_frame=int(f),
                    seed_box=tuple(o["seed_box"]) if o.get("seed_box")
                    else None,
                    positive_prompts=[Sam3Prompt.from_json(p)
                                      for p in o.get("positive", [])],
                    negative_prompts=[Sam3Prompt.from_json(p)
                                      for p in o.get("negative", [])])
                self.by_frame.setdefault(int(f), []).append(obj)
                self._next_id = max(self._next_id, obj.id + 1)
        return self


class SamSegmenter:
    """Promptable segmentation through the port's SAM (``models/sam.py``)
    on `device` (the card unless the caller names the CPU).

    A segment-anything checkpoint converts directly
    (:meth:`from_checkpoint`), or a SAM module comes with a state
    (``convert_sam_checkpoint``, ``state_from_flax``). :meth:`segment`
    matches the ``Sam3InteractiveSession`` ``segment_fn`` contract."""

    def __init__(self, model, state: Optional[dict] = None,
                 mask_threshold: float = 0.0, device=None):
        from ..device import resolve_device
        from ..models.sam import load_state, prepare

        self.device = resolve_device(device)
        if state is not None:
            load_state(model, state)
        self.model = prepare(model, self.device)
        self.mask_threshold = mask_threshold

    @classmethod
    def from_checkpoint(cls, path, dtype=None, device=None):
        """Official segment-anything .pth -> the port's SAM (ViT-B
        shapes), bfloat16 unless `dtype` says otherwise."""
        import torch

        from ..models.sam import SAM, convert_sam_checkpoint

        sd = torch.load(str(path), map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        state = convert_sam_checkpoint(sd)
        model = SAM(dtype=dtype or torch.bfloat16)
        return cls(model, state, device=device)

    @classmethod
    def small_random(cls, img_size: int = 128, seed: int = 0,
                     with_text: bool = False, generator=None, device=None):
        """Tiny float32 model with random weights from `generator` (a
        ``torch.Generator``; seeded with `seed` when none is given), for
        tests and smoke runs; `with_text` adds the concept/text tower."""
        import torch

        from ..models.sam import SAM, init_weights

        model = SAM(img_size=img_size, encoder_dim=64, encoder_depth=2,
                    encoder_heads=2, global_idx=(1,), dtype=torch.float32,
                    with_text=with_text)
        init_weights(model, generator if generator is not None
                     else torch.Generator().manual_seed(seed))
        return cls(model, device=device)

    def segment(self, image: np.ndarray,
                prompts: list) -> dict[int, np.ndarray]:
        """image (H, W[, 3]) uint8; prompts = Sam3PromptObject list with
        box prompts. Returns {object_id: bool mask (H, W)}."""
        import torch

        from ..models.sam import SAM, box_to_prompt, tokenize_text
        from ..track.tag_image import _resize_linear_f32, resize_linear

        if image.ndim == 2:
            image = np.repeat(image[:, :, None], 3, axis=2)
        H, W = image.shape[:2]
        size = self.model.img_size
        scale = size / max(H, W)
        nh, nw = int(round(H * scale)), int(round(W * scale))
        resized = resize_linear(image, (nw, nh))
        # pad with the normalization MEAN so the padded region is 0 in
        # normalized space (official SAM normalizes then zero-pads)
        padded = np.empty((size, size, 3), np.uint8)
        padded[:] = np.round(SAM.PIXEL_MEAN).astype(np.uint8)
        padded[:nh, :nw] = resized

        pts_list, lbl_list, ids = [], [], []
        txt_list, txt_ids = [], []
        for obj in prompts:
            oid = getattr(obj, "id", getattr(obj, "object_id", 0))
            box = getattr(obj, "seed_box", None)
            text = None
            if box is None:
                # fall back to the object's stored prompts: the first
                # box wins; else the first text prompt drives the
                # concept pathway (detect_sam3_prompt text entries)
                for pr in getattr(obj, "positive_prompts", []):
                    b = getattr(pr, "box", None)
                    if b is not None:
                        box = b
                        break
                    t = getattr(pr, "text", None)
                    if t is not None and text is None:
                        text = t
            if box is not None:
                p, l = box_to_prompt([c * scale for c in box])
                pts_list.append(p[0])
                lbl_list.append(l[0])
                ids.append(oid)
            elif text is not None and self.model.with_text:
                txt_list.append(tokenize_text(text))
                txt_ids.append(oid)
        if not pts_list and not txt_list:
            return {}
        dev = self.device
        chosen = []

        def pick(masks, iou):
            # multimask selection considers tokens 1..3 only (token 0 is
            # single-mask mode in official SAM); the first on ties
            best = 1 + iou[:, 1:].argmax(1) if iou.shape[1] > 1 \
                else torch.zeros(len(iou), dtype=torch.int64, device=dev)
            chosen.append(masks[torch.arange(len(iou), device=dev), best])

        with torch.no_grad():
            emb = self.model.encode(torch.from_numpy(padded[None]).to(dev))
            if pts_list:
                pick(*self.model.decode(
                    emb[0], torch.from_numpy(np.stack(pts_list)).to(dev),
                    torch.from_numpy(np.stack(lbl_list)).to(dev)))
            if txt_list:
                pick(*self.model.decode_text(
                    emb[0], torch.from_numpy(np.stack(txt_list)).to(dev)))
            low = torch.cat(chosen).cpu().numpy()  # one transfer a frame
        m = _resize_linear_f32(low, (size, size))[:, :nh, :nw]
        m = _resize_linear_f32(m, (W, H))
        return {oid: m[k] > self.mask_threshold
                for k, oid in enumerate(ids + txt_ids)}


def blobs_from_masks(masks: dict, image: np.ndarray) -> list:
    """Object masks -> TrackBlobs (instance-segmentation flagged),
    pixels = grayscale values under the mask."""
    from ..ops.labeling import label_blobs
    from ..track.blob import TrackBlob

    gray = image if image.ndim == 2 else image[..., 0]
    out = []
    for oid, mask in masks.items():
        img = np.where(mask, np.maximum(gray, 1), 0).astype(np.uint8)
        for b in label_blobs(img, None, threshold=0):
            tb = TrackBlob(b.lines, b.pixels, stats=b.stats)
            tb.prediction = oid
            out.append(tb)
    return out


class SessionState(enum.Enum):
    Idle = "idle"
    Prompted = "prompted"
    Propagating = "propagating"
    Ready = "ready"
    Error = "error"


class Sam3InteractiveSession:
    """Interactive prompting state machine
    (SAM3InteractiveSession.cpp)."""

    def __init__(self, prompts: Optional[Sam3Prompts] = None,
                 segment_fn: Optional[Callable] = None):
        self.prompts = prompts or Sam3Prompts()
        self.segment_fn = segment_fn
        self.state = SessionState.Idle
        self.masks: dict[int, np.ndarray] = {}
        self.error: Optional[str] = None

    def add_prompt(self, frame: int, prompt: Sam3Prompt,
                   box: Optional[tuple] = None) -> Sam3PromptObject:
        obj = self.prompts.add(frame, prompt, box)
        self.state = SessionState.Prompted
        return obj

    def propagate(self, frames, images_fn: Callable[[int], np.ndarray]):
        """Run segmentation over `frames` with the active prompts."""
        if self.state not in (SessionState.Prompted, SessionState.Ready):
            raise RuntimeError(f"cannot propagate from {self.state}")
        if self.segment_fn is None:
            self.state = SessionState.Error
            self.error = ("no SAM3 model attached — provide segment_fn "
                          "(model weights are downloaded at runtime in "
                          "the reference; none are bundled)")
            raise RuntimeError(self.error)
        self.state = SessionState.Propagating
        try:
            for f in frames:
                prompts = self.prompts.materialize(f)
                if prompts:
                    self.masks[f] = self.segment_fn(images_fn(f), prompts)
            self.state = SessionState.Ready
        except Exception as e:
            self.state = SessionState.Error
            self.error = str(e)
            raise

    def reset(self):
        self.state = SessionState.Idle
        self.masks.clear()
        self.error = None


@dataclass
class ProcessedFrame:
    """Result handle from Sam3ReplaySession.process_frame; carries the
    invalidation generation so stale in-flight frames cannot commit."""
    frame_index: int
    generation: int
    result: object = None


class Sam3ReplaySession:
    """The anchor/replay scheduler of SAM3InteractiveSession.cpp,
    behavior pinned by the reference's test_sam3interactivesession.cpp
    (ported in tests/test_sam3.py):

    - the frame after the last committed one runs on the live runtime
      (one predict, no reset, no replay bracket);
    - a forward jump replays last+1..target inside a
      replay_begin/replay_step/replay_finish bracket, loading every
      intermediate frame through `images_fn` (the caller's tile
      provides the target image);
    - re-running a committed frame resets the backend to that frame's
      stored snapshot anchor and predicts without replaying;
    - invalidate_from(f) drops anchors >= f and bumps the generation:
      in-flight frames can no longer commit, and the next
      process_frame resets to the best remaining anchor and replays
      from there.
    """

    def __init__(self, backend, images_fn: Callable[[int], object]):
        self.backend = backend
        self.images_fn = images_fn
        self.prompts: Optional[dict] = None  # parse_prompt_map output
        self._anchors: set[int] = set()
        self._last_committed = -1
        self._generation = 0
        self._runtime_valid = False

    # -- prompt bookkeeping -------------------------------------------
    def set_prompts(self, pmap: Optional[dict]):
        self.prompts = pmap

    def _n_new_prompts(self, frame: int) -> int:
        if not self.prompts:
            return 0
        plist = self.prompts.get(frame)
        return len(plist) if plist else 0

    # -- processing -----------------------------------------------------
    def process_frame(self, frame: int, image=None,
                      attempt: int = 0) -> ProcessedFrame:
        b = self.backend
        gen = self._generation
        if self._runtime_valid and frame == self._last_committed + 1:
            res = b.predict(frame, self._n_new_prompts(frame))
        elif self._runtime_valid and frame > self._last_committed + 1:
            res = self._replay(self._last_committed + 1, frame)
        else:
            anchors = [a for a in self._anchors if a <= frame]
            a = max(anchors) if anchors else 0
            b.reset(a)
            if frame == a:
                res = b.predict(frame, self._n_new_prompts(frame))
            else:
                res = self._replay(a, frame)
            self._runtime_valid = False  # valid again only on commit
        return ProcessedFrame(frame_index=frame, generation=gen,
                              result=res)

    def _replay(self, start: int, end: int):
        b = self.backend
        b.replay_begin(start, end, end - start + 1)
        res = None
        for f in range(start, end + 1):
            if f != end:
                self.images_fn(f)
            res = b.predict(f, self._n_new_prompts(f))
            b.replay_step(1)
        b.replay_finish()
        return res

    def commit_frame(self, processed: ProcessedFrame) -> bool:
        if processed.generation != self._generation:
            return False
        self._anchors.add(processed.frame_index)
        self._last_committed = processed.frame_index
        self._runtime_valid = True
        return True

    def invalidate_from(self, frame: int):
        self._anchors = {a for a in self._anchors if a < frame}
        self._last_committed = min(self._last_committed, frame - 1)
        self._generation += 1
        self._runtime_valid = False
