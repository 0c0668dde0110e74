"""Image dumping: predictions, composites, per-scale assets, submission and
auto-labelling outputs (reference ImageDumper: utils/misc.py:204-417).

The port's copy of ``tpuseg/evaluation/dumper.py``: the same inputs give
the same files, byte for byte, with one exception. An integer input image
wider than uint8 is clipped to 0..255, where ``tpuseg`` wraps it modulo
256."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image

from tpuseg_torch.evaluation.results_page import ResultsPage


def _colorize(mask: np.ndarray, palette: Optional[np.ndarray]) -> Image.Image:
    mask = np.asarray(mask, np.int64) % 256
    if palette is None:  # grayscale fallback when the dataset has no palette
        return Image.fromarray((mask * 13 % 256).astype(np.uint8))
    return Image.fromarray(palette[mask].astype(np.uint8))


def _denormalize(image: np.ndarray, mean, std) -> Image.Image:
    arr = np.asarray(image)
    if np.issubdtype(arr.dtype, np.integer):
        # uint8 wire format (dataset.transfer_uint8): the loader batch
        # carries raw pixels — no host normalization to undo; a wider
        # integer type saturates instead of wrapping
        return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    arr = arr * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    return Image.fromarray(np.clip(arr * 255.0, 0, 255).astype(np.uint8))


class ImageDumper:
    """Writes eval assets to ``dump_dir``.

    Modes (mutually composable, reference: utils/misc.py:204-278):
    - default: every ``dump_frequency``-th image gets input/gt/pred
      composite + individual PNGs (+ attention/per-scale assets);
    - dump_all_images: every image;
    - dump_for_auto_labelling: prediction (trainId) PNG + max-prob PNG,
      the pseudo-label outputs consumed by CITYSCAPES_CUSTOMCOARSE;
    - dump_for_submission: trainId -> labelId remapped PNG only.
    """

    def __init__(self, val_len: int, dump_dir: str,
                 palette: Optional[np.ndarray] = None,
                 mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 trainid_to_id: Optional[np.ndarray] = None,
                 dump_all_images: bool = False, dump_assets: bool = False,
                 dump_num: int = 10,
                 dump_for_auto_labelling: bool = False,
                 dump_for_submission: bool = False):
        self.dump_dir = dump_dir
        self.palette = palette
        self.mean, self.std = mean, std
        self.trainid_to_id = trainid_to_id
        self.dump_assets = dump_assets
        self.dump_for_auto_labelling = dump_for_auto_labelling
        self.dump_for_submission = dump_for_submission
        self.dump_all_images = dump_all_images
        self.viz_frequency = max(1, val_len // max(dump_num, 1))
        self.imgs_to_tensorboard: list = []
        self.imgs_to_webpage: list = []

        if dump_for_submission:
            self.dump_dir = os.path.join(dump_dir, "submit")
        elif dump_for_auto_labelling:
            self.dump_dir = dump_dir
        os.makedirs(self.dump_dir, exist_ok=True)

    def reset(self):
        self.imgs_to_tensorboard = []
        self.imgs_to_webpage = []

    def wants(self, val_idx: int) -> bool:
        """Whether dump() will write anything for this batch index.
        Callers use this to skip the device->host asset transfers
        entirely on batches that won't be dumped."""
        if self.dump_for_auto_labelling or self.dump_for_submission:
            return True
        return self.dump_all_images or (val_idx % self.viz_frequency == 0)

    def dump(self, dump_dict: dict, val_idx: int, testing: bool = False):
        """(reference: utils/misc.py:279-386)"""
        if not self.wants(val_idx):
            return

        for idx in range(len(dump_dict["input_images"])):
            img_name = dump_dict["img_names"][idx]
            prediction = np.asarray(dump_dict["assets"]["predictions"][idx])

            if self.dump_for_submission:
                # trainId -> labelId remap (reference: misc.py:316-324)
                submit = self.trainid_to_id[prediction.astype(np.int64)]
                Image.fromarray(submit.astype(np.uint8)).save(
                    os.path.join(self.dump_dir, f"{img_name}.png"))
                continue

            if self.dump_for_auto_labelling:
                # prediction (trainId -> labelId, same remap as submission)
                # + confidence map (reference: misc.py:310-324 — both dump
                # paths write labelId-space PNGs, which is what the
                # custom-coarse loader's id->trainId remap expects)
                submit = self.trainid_to_id[prediction.astype(np.int64)]
                Image.fromarray(submit.astype(np.uint8)).save(
                    os.path.join(self.dump_dir, f"{img_name}.png"))
                prob = np.asarray(dump_dict["assets"]["prob_mask"][idx])
                Image.fromarray((prob * 255).astype(np.uint8)).save(
                    os.path.join(self.dump_dir, f"{img_name}_prob.png"))
                continue

            input_image = np.asarray(dump_dict["input_images"][idx])
            gt_image = np.asarray(dump_dict["gt_images"][idx])

            er_in = _denormalize(input_image, self.mean, self.std)
            er_in.save(os.path.join(self.dump_dir, f"{img_name}_input.png"))
            gt_pil = _colorize(gt_image, self.palette)
            gt_pil.save(os.path.join(self.dump_dir, f"{img_name}_gt.png"))
            pred_pil = _colorize(prediction, self.palette)
            pred_pil.save(
                os.path.join(self.dump_dir, f"{img_name}_prediction.png"))

            # composite: input blended with prediction (reference: misc.py:352)
            composited = Image.blend(er_in.convert("RGBA"),
                                     pred_pil.convert("RGBA"), 0.4)
            composited.convert("RGB").save(
                os.path.join(self.dump_dir,
                             f"{img_name}_composited.png"))

            to_page = [(f"{img_name}_input.png", "input"),
                       (f"{img_name}_gt.png", "gt"),
                       (f"{img_name}_prediction.png", "prediction"),
                       (f"{img_name}_composited.png", "composited")]

            # keep a bounded set of [input|gt|pred|composited] strips for
            # the TensorBoard grid (reference write_summaries:
            # utils/misc.py:388-417 collates the same quartet)
            if len(self.imgs_to_tensorboard) < 10:
                strip = np.concatenate(
                    [np.asarray(p.convert("RGB"), np.float32) / 255.0
                     for p in (er_in, gt_pil, pred_pil,
                               composited.convert("RGB"))], axis=1)
                self.imgs_to_tensorboard.append(strip)

            if self.dump_assets:
                for asset, value in dump_dict["assets"].items():
                    if asset in ("predictions", "prob_mask", "scale_hists"):
                        continue
                    v = np.asarray(value[idx])
                    fn = f"{img_name}_{asset}.png"
                    if asset.startswith("pred_"):
                        _colorize(v, self.palette).save(
                            os.path.join(self.dump_dir, fn))
                    elif asset.startswith("attn_"):
                        a = np.squeeze(v)
                        Image.fromarray(
                            (np.clip(a, 0, 1) * 255).astype(np.uint8)).save(
                            os.path.join(self.dump_dir, fn))
                    elif asset == "err_mask":
                        Image.fromarray(
                            (v * 255).astype(np.uint8)).save(
                            os.path.join(self.dump_dir, fn))
                    else:
                        continue
                    to_page.append((fn, asset))

            self.imgs_to_webpage.append((img_name, to_page))

    def write_summaries(self, logger, step: int):
        """TensorBoard image grid of the dumped [input|gt|pred|composited]
        strips (reference ImageDumper.write_summaries: utils/misc.py:
        388-417). ``logger`` is a tpuseg_torch Logger; no-op without TB."""
        if not self.imgs_to_tensorboard:
            return
        h = max(s.shape[0] for s in self.imgs_to_tensorboard)
        w = max(s.shape[1] for s in self.imgs_to_tensorboard)
        rows = [np.pad(s, ((0, h - s.shape[0]), (0, w - s.shape[1]), (0, 0)))
                for s in self.imgs_to_tensorboard]
        logger.image("val/dumped_images", np.concatenate(rows, axis=0), step)

    def write_webpage(self):
        """HTML gallery (reference: misc.py:388-417 + results_page.py)."""
        if self.dump_for_submission or self.dump_for_auto_labelling:
            return  # machine-consumed outputs only
        page = ResultsPage("tpuseg results",
                           os.path.join(self.dump_dir, "index.html"))
        for img_name, rows in self.imgs_to_webpage:
            page.add_table([(fn, caption) for fn, caption in rows],
                           table_heading=img_name)
        page.write_page()
