"""Multi-model benchmark comparison harness (the counterpart of
``tmar.eval.harness``).

Runs N model entries over one seeded sample set, collects PSNR / SSIM / MAE
/ RMSE and the per-sample latency, and writes per-model and combined CSV /
JSON, the per-sample outputs (``.npy``) and composite figures, in the JAX
package's file layout.  Entries are (name, forward) pairs, in-process
PyTorch models through ``make_inference_fn``, or runners of the adapter
protocols (``tmar_torch.eval.adapters``).

``latency_s`` is timed around a forward that returns numpy: the copy to the
host waits for the card, so it covers the work and not just the launch.

Failure isolation per model: one model failing records a FAILED row
instead of ending the run.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tmar_torch.eval.metrics import mae, psnr, rmse, ssim


class ModelEntry:
    def __init__(
        self,
        name: str,
        forward: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        runner: Optional[Callable[[Dict], np.ndarray]] = None,
    ):
        """Either interface:

        * ``forward``: [B, H, W, 1] in [-1,1] -> [B, H, W, 1] in [-1,1]
          (in-process models); or
        * ``runner``: enriched benchmark sample dict -> [H, W] pred in [0,1]
          (the adapter protocols of ``tmar_torch.eval.adapters``).
        """
        if (forward is None) == (runner is None):
            raise ValueError("provide exactly one of forward / runner")
        self.name = name
        self.forward = forward
        self.runner = runner


def find_metal_center(ct01: np.ndarray, threshold: float = 0.8) -> Tuple[int, int]:
    """Centroid of the brightest (metal) region, for zoomed crops."""
    mask = ct01 > threshold
    if not mask.any():
        return ct01.shape[0] // 2, ct01.shape[1] // 2
    ys, xs = np.nonzero(mask)
    return int(ys.mean()), int(xs.mean())


def run_comparison(
    entries: Sequence[ModelEntry],
    dataset,
    out_dir: str,
    num_samples: int = 25,
    seed: int = 42,
    save_outputs: bool = True,
    radon=None,
    composite_samples: int = 3,
    indices_cache: Optional[str] = None,
) -> Dict[str, Dict]:
    """Evaluate every entry on the same seeded sample subset.

    When any entry uses the runner interface, samples are enriched into the
    benchmark dict (sinograms synthesized if ``radon`` is given).  After the
    sweep, composite figures with zoomed metal crops and intensity profiles
    are written for the first ``composite_samples`` samples.
    ``indices_cache`` reuses one saved index list across runs, regenerated
    when it was written against another dataset.
    """
    from tmar_torch.eval.adapters import enrich_sample

    os.makedirs(out_dir, exist_ok=True)
    indices = None
    if indices_cache is not None and os.path.exists(indices_cache):
        cached = np.load(indices_cache)
        want = min(num_samples, len(dataset))
        if len(cached) >= want and (len(cached) == 0 or cached.max() < len(dataset)):
            indices = cached[:want]
    if indices is None:
        rng = np.random.default_rng(seed)
        indices = rng.choice(len(dataset), size=min(num_samples, len(dataset)), replace=False)
        if indices_cache is not None:
            os.makedirs(os.path.dirname(indices_cache) or ".", exist_ok=True)
            np.save(indices_cache, indices)
    samples = [dataset[int(i)] for i in indices]
    need_enrich = any(e.runner is not None for e in entries)
    enriched = [enrich_sample(s, radon=radon) for s in samples] if need_enrich else None

    results: Dict[str, Dict] = {}
    for entry in entries:
        model_dir = os.path.join(out_dir, entry.name)
        os.makedirs(model_dir, exist_ok=True)
        rows: List[Dict] = []
        try:
            def _predict(j: int) -> np.ndarray:
                """-> [H, W] prediction in [0, 1]."""
                if entry.runner is not None:
                    return entry.runner(enriched[j])
                ct = samples[j]["ct"][None, ..., None]
                pred = entry.forward(ct)
                return np.clip((np.asarray(pred)[0, ..., 0] + 1) / 2, 0, 1)

            _predict(0)  # warm-up on the first sample's shape
            for j, s in enumerate(samples):
                gt01 = (s["gt"] + 1) / 2
                t0 = time.perf_counter()
                pred01 = _predict(j)
                latency = time.perf_counter() - t0
                rows.append({
                    "sample": int(indices[j]),
                    "psnr": psnr(pred01, gt01),
                    "ssim": ssim(pred01, gt01),
                    "mae": mae(pred01, gt01),
                    "rmse": rmse(pred01, gt01),
                    "latency_s": latency,
                })
                if save_outputs:
                    np.save(os.path.join(model_dir, f"sample_{indices[j]:05d}.npy"), pred01)
            summary = {
                k: {"mean": float(np.mean([r[k] for r in rows])),
                    "std": float(np.std([r[k] for r in rows]))}
                for k in ("psnr", "ssim", "mae", "rmse", "latency_s")
            }
            results[entry.name] = {"status": "ok", "summary": summary, "per_sample": rows}
            _write_per_sample_csv(rows, os.path.join(model_dir, "per_sample.csv"))
        except Exception as e:
            results[entry.name] = {"status": "FAILED", "error": repr(e)}

        with open(os.path.join(model_dir, "metrics.json"), "w") as f:
            json.dump(results[entry.name], f, indent=2)

    _write_combined(results, out_dir)
    write_summary_table(results, os.path.join(out_dir, "summary_table.txt"))
    _write_distribution_figures(results, out_dir)
    if save_outputs and composite_samples:
        _write_composites(results, samples, indices, out_dir, min(composite_samples, len(samples)))
    return results


def write_summary_table(results: Dict[str, Dict], path: str):
    """Aligned text summary table."""
    cols = ["model", "status", "PSNR", "SSIM", "MAE", "RMSE", "ms/sample"]
    rows = []
    for name, res in results.items():
        if res["status"] != "ok":
            rows.append([name, res["status"], "-", "-", "-", "-", "-"])
            continue
        s = res["summary"]
        rows.append([
            name, "ok",
            f"{s['psnr']['mean']:.2f}±{s['psnr']['std']:.2f}",
            f"{s['ssim']['mean']:.4f}±{s['ssim']['std']:.4f}",
            f"{s['mae']['mean']:.5f}",
            f"{s['rmse']['mean']:.5f}",
            f"{s['latency_s']['mean'] * 1000:.1f}",
        ])
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths)),
             "  ".join("-" * w for w in widths)]
    lines += ["  ".join(v.ljust(w) for v, w in zip(r, widths)) for r in rows]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _write_distribution_figures(results: Dict[str, Dict], out_dir: str):
    """Boxplots and per-image metric traces over all ok models."""
    per_model = {name: res["per_sample"] for name, res in results.items()
                 if res["status"] == "ok" and res.get("per_sample")}
    if not per_model:
        return
    try:
        from tmar_torch.eval.figures import plot_metric_boxplots, plot_per_image_metrics
    except Exception:
        return  # matplotlib unavailable
    fig_dir = os.path.join(out_dir, "figures")
    os.makedirs(fig_dir, exist_ok=True)
    plot_metric_boxplots(per_model, os.path.join(fig_dir, "metric_boxplots.png"))
    plot_per_image_metrics(per_model, os.path.join(fig_dir, "per_image_psnr.png"))


def _write_per_sample_csv(rows: List[Dict], path: str):
    import csv

    if not rows:
        return
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _write_composites(results, samples, indices, out_dir, n):
    """Composite and intensity-profile figures from the saved per-model npys."""
    try:
        from tmar_torch.eval.figures import composite_figure, intensity_profiles
    except Exception:
        return  # matplotlib unavailable
    fig_dir = os.path.join(out_dir, "figures")
    os.makedirs(fig_dir, exist_ok=True)
    ok_models = [m for m, r in results.items() if r["status"] == "ok"]
    for j in range(n):
        idx = int(indices[j])
        ct01 = np.clip((samples[j]["ct"] + 1) / 2, 0, 1)
        gt01 = np.clip((samples[j]["gt"] + 1) / 2, 0, 1)
        outputs = {}
        for m in ok_models:
            p = os.path.join(out_dir, m, f"sample_{idx:05d}.npy")
            if os.path.exists(p):
                outputs[m] = np.load(p)
        if not outputs:
            continue
        composite_figure(ct01, gt01, outputs,
                         os.path.join(fig_dir, f"composite_sample_{idx:05d}.png"))
        intensity_profiles(outputs, gt01, ct01,
                           os.path.join(fig_dir, f"profiles_sample_{idx:05d}.png"))


def _write_combined(results: Dict[str, Dict], out_dir: str):
    import csv

    with open(os.path.join(out_dir, "summary.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["model", "status", "psnr_mean", "psnr_std", "ssim_mean",
                    "ssim_std", "mae_mean", "rmse_mean", "latency_mean_s"])
        for name, res in results.items():
            if res["status"] != "ok":
                w.writerow([name, res["status"], *[""] * 7])
                continue
            s = res["summary"]
            w.writerow([
                name, "ok",
                f"{s['psnr']['mean']:.4f}", f"{s['psnr']['std']:.4f}",
                f"{s['ssim']['mean']:.6f}", f"{s['ssim']['std']:.6f}",
                f"{s['mae']['mean']:.6f}", f"{s['rmse']['mean']:.6f}",
                f"{s['latency_s']['mean']:.5f}",
            ])
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({name: res.get("summary", {"status": res["status"]})
                   for name, res in results.items()}, f, indent=2)
