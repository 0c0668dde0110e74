"""Worst-case failure analysis: top-N worst images per class.

The port of ``tpuseg/evaluation/topn.py`` (reference: validate_topn,
utils/trnval_utils.py:201-348). Two passes:
1. score every val image's per-class FP+FN pixel counts from its
   confusion matrix;
2. re-run and dump assets for the selected worst images, plus an HTML
   failure gallery grouped by class.
"""
from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from tpuseg_torch.evaluation.dumper import ImageDumper
from tpuseg_torch.evaluation.inference import EvalRunner, calc_err_mask
from tpuseg_torch.evaluation.metrics import eval_metrics_from_hist
from tpuseg_torch.evaluation.results_page import ResultsPage


def metrics_per_image(hist: np.ndarray):
    """Per-class FP/FN pixel counts from one image's confusion matrix
    (reference metrics_per_image: utils/misc.py)."""
    tp = np.diag(hist)
    fp = hist.sum(axis=0) - tp
    fn = hist.sum(axis=1) - tp
    return fp, fn


def validate_topn(val_loader, runner: EvalRunner, num_classes: int, result_dir: str,
                  trainid_to_name=None, dump_topn: int = 10,
                  dump_topn_all: bool = False, palette=None,
                  mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                  log=print, max_images: int | None = None):
    trainid_to_name = trainid_to_name or {
        i: str(i) for i in range(num_classes)}

    # -- pass 1: score ------------------------------------------------------
    log("topn pass 1: scoring")
    image_metrics = {}
    total_hist = np.zeros((num_classes, num_classes), np.float64)
    for val_idx, batch in enumerate(val_loader):
        if max_images and val_idx >= max_images:
            break
        # scoring needs only the confusion matrix — skip the full-res
        # asset readbacks (see EvalRunner.run_batch); one sync an image
        _, hist, _ = runner.run_batch(batch, calc_metrics=False,
                                      need_assets=False)
        fp, fn = metrics_per_image(hist)
        image_metrics[batch["name"][0]] = (fp, fn)
        total_hist += hist

    metrics = eval_metrics_from_hist(total_hist)
    log(f"topn: overall mIoU {metrics.mean_iou:.4f}")

    # -- select worst per class --------------------------------------------
    worst_images: dict = defaultdict(dict)
    class_to_images: dict = defaultdict(dict)
    for classid in range(num_classes):
        tbl = {name: int(fp[classid] + fn[classid])
               for name, (fp, fn) in image_metrics.items()}
        for name in sorted(tbl, key=tbl.get, reverse=True)[:dump_topn]:
            worst_images[name][classid] = tbl[name]
            class_to_images[classid][name] = tbl[name]

    # -- pass 2: dump -------------------------------------------------------
    log("topn pass 2: dumping")
    out_dir = os.path.join(result_dir, "best_images")
    dumper = ImageDumper(val_len=1, dump_dir=out_dir, palette=palette,
                         mean=mean, std=std, dump_all_images=True,
                         dump_assets=True)
    for val_idx, batch in enumerate(val_loader):
        if max_images and val_idx >= max_images:
            break
        name = batch["name"][0]
        if not dump_topn_all and name not in worst_images:
            continue
        assets, _, _ = runner.run_batch(batch, calc_metrics=False)
        pred = assets["predictions"]
        gt = np.asarray(batch["label"])
        for classid, fail_pixels in worst_images[name].items():
            class_name = trainid_to_name.get(classid, str(classid))
            log(f"{name} {class_name}: {fail_pixels}")
            class_assets = dict(assets)
            class_assets["err_mask"] = calc_err_mask(pred, gt, classid)
            dumper.dump({"input_images": batch["image"],
                         "gt_images": batch["label"],
                         "img_names": [f"{name}_{class_name}"],
                         "assets": class_assets}, val_idx)

    # -- failure gallery ----------------------------------------------------
    page = ResultsPage("topn failures",
                       os.path.join(out_dir, "topn_failures.html"))
    for classid in class_to_images:
        class_name = trainid_to_name.get(classid, str(classid))
        img_dict = class_to_images[classid]
        for name in sorted(img_dict, key=img_dict.get, reverse=True):
            img_cls = f"{name}_{class_name}"
            page.add_table(
                [(f"{img_cls}_prediction.png", "pred"),
                 (f"{img_cls}_gt.png", "gt"),
                 (f"{img_cls}_input.png", "input"),
                 (f"{img_cls}_err_mask.png", "errors")],
                table_heading=f"{class_name}-{img_dict[name]}")
    page.write_page()
    return metrics
