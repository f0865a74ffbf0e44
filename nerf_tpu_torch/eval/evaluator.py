"""NeRF evaluator; counterpart of ``nerf_tpu/eval/evaluator.py``.

Per image MSE, PSNR and SSIM (``metrics.py``), ``view{NNN}_{pred,gt}.png``
under ``<result_dir>/images`` (the port's PNG encoder), and ``summarize()``
writing ``metrics/evaluation_results.json`` (the summary's means and
standard deviations and a per-image list) and ``evaluation_summary.txt``,
with the same printed lines.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.png import write_png
from .metrics import mse as mse_fn, psnr as psnr_fn, ssim as ssim_fn


def to8b(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


class Evaluator:
    def __init__(self, result_dir: str, save_images: bool = True,
                 background_strategy: str = "none"):
        self.result_dir = result_dir
        self.save_images = save_images
        self.background_strategy = background_strategy
        self.reset()

    def reset(self):
        self.mse: List[float] = []
        self.psnr: List[float] = []
        self.ssim: List[float] = []
        self.imgs: List[Dict] = []

    @staticmethod
    def _to_unit_range(img: np.ndarray, name: str) -> np.ndarray:
        """[0, 255]-scaled inputs (max > 2) are divided by 255 before
        clipping; a float prediction marginally above 1 is clipped."""
        img = np.asarray(img, np.float32)
        if img.size and float(img.max()) > 2.0:
            print(f"WARNING: {name} image not in [0,1]; "
                  "auto-normalizing from [0,255]")
            img = img / 255.0
        return np.clip(img, 0, 1)

    def evaluate(self, pred_rgb: np.ndarray, gt_rgb: np.ndarray, idx: int) -> Dict:
        """pred/gt: [H, W, 3] float in [0,1]."""
        pred = self._to_unit_range(pred_rgb, "predicted")
        gt = self._to_unit_range(gt_rgb, "ground truth")
        if self.background_strategy != "none":
            from .background import convert_background

            gt = convert_background(gt, self.background_strategy)
        m = mse_fn(pred, gt)
        p = psnr_fn(pred, gt)
        s = ssim_fn(pred, gt, win_size=min(7, min(pred.shape[0], pred.shape[1])))
        self.mse.append(m)
        self.psnr.append(p)
        self.ssim.append(s)
        self.imgs.append({"id": idx, "mse": m, "psnr": p, "ssim": s})
        if self.save_images:
            img_dir = os.path.join(self.result_dir, "images")
            os.makedirs(img_dir, exist_ok=True)
            write_png(os.path.join(img_dir, f"view{idx:03d}_pred.png"), to8b(pred))
            write_png(os.path.join(img_dir, f"view{idx:03d}_gt.png"), to8b(gt))
        print(f"Image {idx}: PSNR={p:.2f}, SSIM={s:.4f}, MSE={m:.6f}")
        return {"mse": m, "psnr": p, "ssim": s}

    def summarize(self) -> Optional[Dict]:
        if not self.psnr:
            print("No evaluation results to summarize")
            return None
        summary = {
            "num_images": len(self.psnr),
            "avg_mse": float(np.mean(self.mse)),
            "avg_psnr": float(np.mean(self.psnr)),
            "avg_ssim": float(np.mean(self.ssim)),
            "std_mse": float(np.std(self.mse)),
            "std_psnr": float(np.std(self.psnr)),
            "std_ssim": float(np.std(self.ssim)),
        }
        print("=" * 50)
        print("EVALUATION SUMMARY")
        print("=" * 50)
        print(f"Number of images evaluated: {summary['num_images']}")
        print(f"Average MSE: {summary['avg_mse']:.6f} ± {summary['std_mse']:.6f}")
        print(f"Average PSNR: {summary['avg_psnr']:.2f} ± {summary['std_psnr']:.2f}")
        print(f"Average SSIM: {summary['avg_ssim']:.4f} ± {summary['std_ssim']:.4f}")
        print("=" * 50)

        metrics_dir = os.path.join(self.result_dir, "metrics")
        os.makedirs(metrics_dir, exist_ok=True)
        results = {
            "summary": summary,
            "per_image": [
                {k: (int(v) if k == "id" else float(v)) for k, v in d.items()}
                for d in self.imgs
            ],
        }
        with open(os.path.join(metrics_dir, "evaluation_results.json"), "w") as f:
            json.dump(results, f, indent=4)
        with open(os.path.join(metrics_dir, "evaluation_summary.txt"), "w") as f:
            f.write(f"Number of images: {summary['num_images']}\n")
            f.write(f"Average PSNR: {summary['avg_psnr']:.2f} ± {summary['std_psnr']:.2f}\n")
            f.write(f"Average SSIM: {summary['avg_ssim']:.4f} ± {summary['std_ssim']:.4f}\n")
            f.write(f"Average MSE: {summary['avg_mse']:.6f} ± {summary['std_mse']:.6f}\n")
        return {
            "avg_psnr": summary["avg_psnr"],
            "avg_ssim": summary["avg_ssim"],
            "avg_mse": summary["avg_mse"],
        }
