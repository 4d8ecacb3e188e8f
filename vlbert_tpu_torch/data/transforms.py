"""Host-side image/box transforms in numpy (NHWC output for TPU).

ref: vcr/data/transforms/transforms.py (Resize :28-66, RandomHorizontalFlip
:69-79, ToTensor/Normalize :82-97 with BGRx255 caffe means, FixPadding
:100-120) and the vqa/refcoco variants that thread a ``flipped`` flag and
tolerate image=None (precomputed mode,
vqa/data/transforms/transforms.py:14-17,56-68).

Images flow as float32 numpy [H, W, 3] RGB in [0, 1]; Normalize converts to
BGRx255 minus caffe pixel means (reference ToTensor+Normalize combo);
FixPadding produces the static canvas XLA needs.

Port copy of ``vlbert_tpu/data/transforms.py``, unchanged but for its
imports: the port imports nothing of the JAX package.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def resize_size(w, h, min_size, max_size):
    """Shortest-edge resize with max cap (ref :34-54)."""
    size = min_size
    if max_size is not None:
        mn, mx = float(min(w, h)), float(max(w, h))
        if mx / mn * size > max_size:
            size = int(max_size * mn / mx)
    if (w <= h and w == size) or (h <= w and h == size):
        return w, h
    if w < h:
        return size, int(size * h / w)
    return int(size * w / h), size


class Resize:
    def __init__(self, min_size, max_size, impl="pil"):
        self.min_size = min_size
        self.max_size = max_size
        self.impl = impl

    def __call__(self, s):
        if s["image"] is None:
            # precomputed mode still rescales boxes by a ratio of 1
            # (vqa variant tolerates image=None)
            s["im_info"][2] = s["im_info"][3] = 1.0
            return s
        h, w = s["image"].shape[:2]
        ow, oh = resize_size(w, h, self.min_size, self.max_size)
        if (ow, oh) != (w, h):
            s["image"] = _resize_bilinear(s["image"], oh, ow,
                                          impl=self.impl)
        rw, rh = ow / w, oh / h
        if s["boxes"] is not None:
            s["boxes"][:, [0, 2]] *= rw
            s["boxes"][:, [1, 3]] *= rh
        s["im_info"][0], s["im_info"][1] = ow, oh
        s["im_info"][2], s["im_info"][3] = rw, rh
        return s


def _resize_bilinear(img, oh, ow, impl="pil"):
    """Bilinear resize (host-side).

    impl='pil' (default) is the exact-parity path: PIL's antialiased
    bilinear, identical to the reference's torchvision-on-PIL resize.
    impl='cv2' uses OpenCV INTER_LINEAR — ~5x faster per image (measured
    0.56 vs 3.15 ms at 640->608) and <=1 LSB mean divergence from PIL on
    natural images at the near-unity scales this pipeline uses (shortest
    edge 600/608 from movie-frame sources); shipped in the v5e-tuned
    configs (TPU.RESIZE_IMPL), while the reference-parity configs keep
    'pil'. uint8 input stays uint8 (no float round trip); float input
    keeps the legacy [0, 1] contract for callers that pre-normalized.
    """
    if impl == "cv2":
        try:
            import cv2

            # one worker = one core: OpenCV's own thread pool only adds
            # contention inside loader worker processes
            cv2.setNumThreads(0)
            if img.dtype == np.uint8:
                return cv2.resize(img, (ow, oh),
                                  interpolation=cv2.INTER_LINEAR)
            out = cv2.resize(img.astype(np.float32), (ow, oh),
                             interpolation=cv2.INTER_LINEAR)
            return out
        except ImportError:
            pass        # fall through to the parity path
    try:
        from PIL import Image

        if img.dtype == np.uint8:
            return np.asarray(
                Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
        pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        out = pil.resize((ow, oh), Image.BILINEAR)
        return np.asarray(out, np.float32) / 255.0
    except ImportError:
        import torch
        import torch.nn.functional as TF

        t = torch.from_numpy(img.astype(np.float32)).permute(2, 0, 1)[None]
        out = TF.interpolate(t, size=(oh, ow), mode="bilinear",
                             align_corners=False)
        out = out[0].permute(1, 2, 0).numpy()
        if img.dtype == np.uint8:
            # round, don't truncate: astype would drift up to 1 LSB vs the
            # PIL path (PIL rounds its bilinear output)
            return np.rint(out).clip(0, 255).astype(np.uint8)
        return out


class RandomHorizontalFlip:
    def __init__(self, prob=0.5, rng=None):
        self.prob = prob
        self.rng = rng or np.random.default_rng()

    def __call__(self, s):
        if self.rng.random() < self.prob:
            s["flipped"] = True
            if s["image"] is not None:
                h, w = s["image"].shape[:2]
            else:
                w = s["im_info"][0]
            # negative-stride VIEWS, not copies: FixPadding's canvas write
            # (images) and the collator's static-bucket pad (masks) each
            # materialize a fresh contiguous array anyway, so an eager
            # .copy() here was a pure extra memcpy per flipped sample
            s["image"] = s["image"][:, ::-1] if s["image"] is not None \
                else None
            if s["boxes"] is not None:
                b = s["boxes"]
                b[:, [0, 2]] = w - 1 - b[:, [2, 0]]          # ref :77
            if s.get("masks") is not None:
                s["masks"] = s["masks"][:, :, ::-1]
        return s


class Normalize:
    """BGRx255 caffe normalization (ref :87-97 + ToTensor)."""

    def __init__(self, mean, std, to_bgr255=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_bgr255 = to_bgr255

    def __call__(self, s):
        if s["image"] is None:
            return s
        img = s["image"]
        # reference semantics: to_bgr255=True -> BGR 0-255 scale (caffe
        # means); to_bgr255=False -> ToTensor's RGB 0-1 scale (its means
        # are 0-1-scale too)
        if img.dtype == np.uint8:
            # uint8 pixels ARE the 255-scale values the reference reaches
            # via ToTensor(/255) -> Normalize(*255); one float pass here
            out = (img[:, :, ::-1].astype(np.float32) if self.to_bgr255
                   else img.astype(np.float32) / 255.0)
        else:
            out = (img[:, :, ::-1] * 255.0 if self.to_bgr255
                   else np.array(img, np.float32))
        out -= self.mean
        if not np.all(self.std == 1.0):
            out /= self.std
        s["image"] = out
        return s


class FixPadding:
    """Pad to the deterministic (min,max) canvas (ref :100-120) —
    static shapes for XLA."""

    def __init__(self, min_size, max_size, pad=0):
        self.min_size = min_size
        self.max_size = max_size
        self.pad = pad

    def __call__(self, s):
        if s["image"] is None:
            return s
        h, w = s["image"].shape[:2]
        if h <= w:
            h1, w1 = self.min_size, self.max_size
        else:
            h1, w1 = self.max_size, self.min_size
        # dtype-preserving: float32 after host Normalize, uint8 in the
        # device-normalize path (padding is re-zeroed on device from im_info)
        dtype = s["image"].dtype if s["image"].dtype == np.uint8 \
            else np.float32
        canvas = np.full((h1, w1, s["image"].shape[2]), self.pad, dtype)
        canvas[:h, :w] = s["image"]
        s["image"] = canvas
        return s


def build_transforms(cfg, mode="train", rng=None, device_norm=False):
    """ref: <task>/data/build.py:17-41.

    device_norm=True keeps images uint8 end-to-end on the host (resize,
    flip, pad); the BGR255-mean normalization then runs inside the jitted
    step (ops/image_norm.py) — 4x less host memory traffic and H2D volume,
    numerically identical.
    """
    flip_prob = (cfg.TRAIN.FLIP_PROB if mode == "train"
                 else cfg.VAL.FLIP_PROB if mode == "val" else cfg.TEST.FLIP_PROB)
    min_size, max_size = (min(cfg.SCALES), max(cfg.SCALES)) if cfg.SCALES \
        else (600, 1000)
    mean = cfg.NETWORK.PIXEL_MEANS or (102.9801, 115.9465, 122.7717)
    std = cfg.NETWORK.PIXEL_STDS or (1.0, 1.0, 1.0)
    resize_impl = cfg.TPU.get("RESIZE_IMPL", "pil") if "TPU" in cfg else "pil"
    chain = [
        Resize(min_size, max_size, impl=resize_impl),
        RandomHorizontalFlip(flip_prob, rng=rng),
    ]
    if not device_norm:
        chain.append(Normalize(mean, std, to_bgr255=True))
    chain.append(FixPadding(min_size, max_size))
    return Compose(chain)
