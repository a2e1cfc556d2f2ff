"""Ablation evaluation engine (the counterpart of ``tmar.eval.ablation``):

* ``fixed_vis_indices``: one seeded visualisation sample set shared across
  every ablation, so the figures are directly comparable;
* ``evaluate_run``: test-set evaluation of a trained (or restored)
  generator with the global, regional and HU metric families written to
  metrics.csv / json, and the plot families (loss and metric curves, error
  heatmaps, histograms, regional bars, intensity profiles, tissue
  segmentation, artifact waves, vis triplets) for the fixed vis samples;
  also the engine of the inference-only re-evaluation;
* ``cross_ablation_summary``: the combined CSV / JSON and PSNR / SSIM bar
  charts across ablations, FAILED rows kept.

The plots need matplotlib; without it they are skipped and everything else
is written.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from tmar_torch.eval import metrics as M


def fixed_vis_indices(dataset_len: int, k: int = 8, seed: int = 42) -> List[int]:
    rng = np.random.default_rng(seed)
    k = min(k, dataset_len)
    return sorted(int(i) for i in rng.choice(dataset_len, size=k, replace=False))


def _sample_metrics(pred: np.ndarray, gt: np.ndarray, ct: np.ndarray) -> Dict[str, float]:
    """All metric families for one slice; pred/gt/ct in [-1, 1]."""
    p01 = np.clip((pred + 1) / 2, 0, 1)
    g01 = np.clip((gt + 1) / 2, 0, 1)
    row: Dict[str, float] = {
        "psnr": M.psnr(p01, g01),
        "ssim": M.ssim(p01, g01),
        "mae": M.mae(p01, g01),
        "rmse": M.rmse(p01, g01),
    }
    row.update(M.compute_regional_metrics(pred, gt, ct))
    hu = M.compute_hu_accuracy(p01, g01)
    row.update({k: v for k, v in hu.items() if not k.endswith("pixel_count")})
    row.update(M.hu_tolerance_rates(p01, g01))
    return row


def evaluate_run(
    forward: Callable[[np.ndarray], np.ndarray],
    dataset,
    out_dir: str,
    vis_indices: Sequence[int] = (),
    max_samples: Optional[int] = None,
    history: Optional[List[Dict]] = None,
    val_history: Optional[List[Dict]] = None,
    name: str = "model",
) -> Dict[str, float]:
    """Evaluate ``forward`` ([B,H,W,1]->[B,H,W,1] in [-1,1]) over the test
    set; write metrics.csv/json + the plot families; return the summary."""
    os.makedirs(out_dir, exist_ok=True)
    plots = os.path.join(out_dir, "plots")
    os.makedirs(plots, exist_ok=True)

    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    rows: List[Dict] = []
    vis_set = set(int(i) for i in vis_indices)
    vis_data: Dict[int, Dict[str, np.ndarray]] = {}
    for i in range(n):
        s = dataset[i]
        ct, gt = s["ct"], s["gt"]
        pred = np.asarray(forward(ct[None, ..., None]))[0, ..., 0]
        row = {"index": i}
        row.update(_sample_metrics(pred, gt, ct))
        rows.append(row)
        if i in vis_set:
            vis_data[i] = {"ct": ct, "gt": gt, "pred": pred}

    with open(os.path.join(out_dir, "metrics.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    summary = {
        k: float(np.mean([r[k] for r in rows])) for k in rows[0] if k != "index"
    }
    summary["n_samples"] = n
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump({"summary": summary, "per_sample_csv": "metrics.csv"}, f, indent=2)

    _render_plots(name, plots, vis_data, summary, history, val_history)
    return summary


def _render_plots(name, plots, vis_data, summary, history, val_history):
    try:
        from tmar_torch.eval import figures as F
    except Exception:
        return  # matplotlib unavailable
    if history:
        F.plot_loss_curves(history, os.path.join(plots, "loss_curves.png"))
    if val_history:
        F.plot_metric_curves(val_history, os.path.join(plots, "metric_curves.png"))
    F.plot_regional_comparison(
        {name: summary}, os.path.join(plots, "regional_psnr.png")
    )
    for i, d in vis_data.items():
        p01 = np.clip((d["pred"] + 1) / 2, 0, 1)
        g01 = np.clip((d["gt"] + 1) / 2, 0, 1)
        c01 = np.clip((d["ct"] + 1) / 2, 0, 1)
        tag = f"sample_{i:05d}"
        F.figure_error_heatmaps(
            {name: p01}, g01, os.path.join(plots, f"error_heatmap_{tag}.png")
        )
        F.plot_histograms({name: p01}, g01, os.path.join(plots, f"histogram_{tag}.png"))
        F.intensity_profiles({name: p01}, g01, c01, os.path.join(plots, f"profiles_{tag}.png"))
        F.plot_intensity_segmentation(p01, g01, os.path.join(plots, f"segmentation_{tag}.png"))
        F.plot_artifact_waves(p01, g01, c01, os.path.join(plots, f"artifact_waves_{tag}.png"))
        F.composite_figure(c01, g01, {name: p01}, os.path.join(plots, f"triplet_{tag}.png"))


def cross_ablation_summary(results: Dict[str, Dict], out_dir: str) -> str:
    """Combined CSV/JSON + bar charts over all ablations; FAILED rows kept."""
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "ablation_summary.csv")
    keys = ["psnr", "ssim", "mae", "rmse", "metal_PSNR", "band_PSNR",
            "non_metal_PSNR", "overall_HU_MAE", "within_10HU"]
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["ablation", "status"] + keys)
        for name in sorted(results):
            r = results[name]
            if r.get("status") != "ok":
                w.writerow([name, r.get("status", "FAILED")] + [""] * len(keys))
                continue
            s = r["summary"]
            w.writerow([name, "ok"] + [f"{s.get(k, float('nan')):.6f}" for k in keys])
    with open(os.path.join(out_dir, "ablation_summary.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)

    try:
        from tmar_torch.eval import figures as F  # noqa: F401
        import matplotlib.pyplot as plt

        ok = {n: r["summary"] for n, r in results.items() if r.get("status") == "ok"}
        if ok:
            for metric in ("psnr", "ssim"):
                fig, ax = plt.subplots(figsize=(max(6, 1.2 * len(ok)), 4))
                names = sorted(ok)
                ax.bar(names, [ok[n].get(metric, 0.0) for n in names])
                ax.set_ylabel(metric.upper())
                ax.grid(alpha=0.3, axis="y")
                plt.setp(ax.get_xticklabels(), rotation=30, ha="right", fontsize=8)
                fig.tight_layout()
                fig.savefig(os.path.join(out_dir, f"ablation_{metric}_bars.png"), dpi=150)
                plt.close(fig)
    except Exception:
        pass
    return csv_path
