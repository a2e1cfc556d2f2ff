"""Paper-figure generation (the counterpart of ``tmar.eval.figures``), as
library functions over matplotlib (Agg):

* ``compute_artifact_score`` / ``select_best_slices`` — artifact-visibility
  slice ranking (shared_config.py:177-265): score = metal_area ·
  artifact_intensity · artifact_pixels, top-k cached to npy.
* ``figure_metal_aware_masks`` — mask construction + radius comparison
  (figure3_metal_aware_masks.py, figure3_radius_comparison.py).
* ``figure_physics_consistency`` — sinogram-residual pipeline incl.
  back-projection of the residual (figure2_physics_consistency_v2.py), using
  the port's Radon/FBP operators on the card unless ``device`` says "cpu".
* ``figure_multiscale_receptive_fields`` — D receptive-field visualisation
  (figure4_multiscale_discriminator.py).
* ``figure_error_heatmaps`` — |pred − gt| heatmaps (figure7) and
  ``figure_mse_limitation`` (figure1).
* ``plot_loss_curves`` — training history curves (train_combined.py:347-386).
* ``intensity_profiles`` — line profiles through the metal centre
  (generate_intensity_profiles.py).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from tmar_torch.eval.harness import find_metal_center  # noqa: E402


# ------------------------------------------------------------- slice ranking
def compute_artifact_score(ct01: np.ndarray, gt01: np.ndarray, metal_thr: float = 0.8,
                           artifact_thr: float = 0.1) -> float:
    """metal_area · artifact_intensity · artifact_pixels
    (reference shared_config.py:177-213)."""
    metal = ct01 > metal_thr
    diff = np.abs(ct01 - gt01) * ~metal
    artifact_pixels = (diff > artifact_thr).sum()
    artifact_intensity = diff[diff > artifact_thr].mean() if artifact_pixels else 0.0
    return float(metal.sum() * artifact_intensity * artifact_pixels)


def select_best_slices(dataset, k: int = 25, cache_path: Optional[str] = None) -> List[int]:
    """Rank dataset samples by artifact visibility; cache to npy
    (shared_config.py:215-265)."""
    if cache_path and os.path.exists(cache_path):
        return [int(i) for i in np.load(cache_path)]
    scores = []
    for i in range(len(dataset)):
        s = dataset[i]
        ct01, gt01 = (s["ct"] + 1) / 2, (s["gt"] + 1) / 2
        scores.append((compute_artifact_score(ct01, gt01), i))
    top = [i for _, i in sorted(scores, reverse=True)[:k]]
    if cache_path:
        np.save(cache_path, np.asarray(top))
    return top


# ------------------------------------------------------------------- figures
def figure_metal_aware_masks(ct: np.ndarray, out_path: str,
                             radii: Sequence[int] = (0, 3, 5, 7),
                             threshold: float = 0.6):
    """Metal mask M, dilated band B and weight map w per radius; ct in [-1,1]."""
    import torch

    from tmar_torch.losses.gan_losses import compute_weight_map, extract_metal_mask

    ct4 = torch.from_numpy(np.asarray(ct, np.float32)[None, ..., None])
    M = extract_metal_mask(ct4, threshold).numpy()[0, ..., 0]
    fig, axes = plt.subplots(2, len(radii) + 1, figsize=(3 * (len(radii) + 1), 6))
    axes[0, 0].imshow((ct + 1) / 2, cmap="gray"); axes[0, 0].set_title("input")
    axes[1, 0].imshow(M, cmap="hot"); axes[1, 0].set_title("metal mask M")
    for j, r in enumerate(radii):
        w = compute_weight_map(ct4, radius=r).numpy()[0, ..., 0]
        axes[0, j + 1].imshow(w, cmap="viridis", vmin=1, vmax=3)
        axes[0, j + 1].set_title(f"w (r={r})")
        axes[1, j + 1].imshow((w > 1) & (M == 0), cmap="hot")
        axes[1, j + 1].set_title(f"band (r={r})")
    for ax in axes.ravel():
        ax.axis("off")
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def figure_physics_consistency(pred: np.ndarray, gt: np.ndarray, ct: np.ndarray,
                               out_path: str, num_angles: int = 180,
                               threshold: float = 0.6, device="cuda"):
    """Sinogram residual outside the metal trace + FBP of the residual
    (figure2_physics_consistency_v2.py), all in [-1,1] 2-D inputs; the
    Radon operator runs on ``device``."""
    import torch

    from tmar_torch.losses.gan_losses import extract_metal_mask
    from tmar_torch.ops.radon import Radon

    size = pred.shape[0]
    radon = Radon(size, np.linspace(0, np.pi, num_angles, endpoint=False), device=device)

    def on_radon(fn, img):
        with torch.no_grad():
            t = torch.from_numpy(np.asarray(img, np.float32)[None]).to(radon.device)
            return fn(t).cpu().numpy()[0]

    P = lambda img: on_radon(radon.forward, img)  # noqa: E731
    sino_pred, sino_gt = P(pred), P(gt)
    M = extract_metal_mask(torch.from_numpy(np.asarray(ct, np.float32)[None, ..., None]),
                           threshold).numpy()[0, ..., 0]
    trace = (P(M) > 0).astype(np.float32)
    residual = (1 - trace) * np.abs(sino_pred - sino_gt)
    bp = on_radon(radon.fbp, (1 - trace) * (sino_pred - sino_gt))

    fig, axes = plt.subplots(2, 3, figsize=(13, 8))
    for ax, img, title, cmap in (
        (axes[0, 0], (pred + 1) / 2, "prediction", "gray"),
        (axes[0, 1], sino_pred, "P(pred)", "magma"),
        (axes[0, 2], trace, "metal trace Mp", "hot"),
        (axes[1, 0], (gt + 1) / 2, "ground truth", "gray"),
        (axes[1, 1], residual, "(1-Mp)|P(pred)-P(gt)|", "magma"),
        (axes[1, 2], bp, "FBP of residual", "coolwarm"),
    ):
        im = ax.imshow(img, cmap=cmap, aspect="auto")
        ax.set_title(title); ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def figure_multiscale_receptive_fields(image: np.ndarray, out_path: str,
                                       num_layers: int = 5):
    """Receptive-field extents of the 3 D scales overlaid on the input
    (figure4_multiscale_discriminator.py).  PatchGAN RF for k=4 convs with
    strides (2,2,2,2,1): r = 1 + Σ (k-1)·Πstrides = 61; doubles per ½× scale."""
    rf = 1
    jump = 1
    for stride in (2, 2, 2, 2, 1)[:num_layers]:
        rf = rf + (4 - 1) * jump
        jump *= stride
    fig, axes = plt.subplots(1, 3, figsize=(14, 5))
    H, W = image.shape
    for s, ax in enumerate(axes):
        eff = rf * (2**s)
        ax.imshow((image + 1) / 2, cmap="gray")
        cy, cx = H // 2, W // 2
        half = min(eff // 2, H // 2 - 1)
        ax.add_patch(plt.Rectangle((cx - half, cy - half), 2 * half, 2 * half,
                                   fill=False, color="r", lw=2))
        ax.set_title(f"D scale 1/{2**s}: RF ≈ {eff}px")
        ax.axis("off")
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def figure_error_heatmaps(preds: Dict[str, np.ndarray], gt: np.ndarray,
                          out_path: str, vmax: Optional[float] = None):
    """|pred − gt| heatmaps per model (figure7_error_heatmaps.py); [0,1] in."""
    n = len(preds)
    fig, axes = plt.subplots(1, n + 1, figsize=(4 * (n + 1), 4))
    axes[0].imshow(gt, cmap="gray"); axes[0].set_title("ground truth"); axes[0].axis("off")
    for ax, (name, p) in zip(axes[1:], preds.items()):
        err = np.abs(p - gt)
        im = ax.imshow(err, cmap="inferno", vmax=vmax or err.max())
        ax.set_title(f"{name}\nMAE={err.mean():.4f}"); ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def figure_mse_limitation(blurry: np.ndarray, sharp: np.ndarray, gt: np.ndarray,
                          out_path: str):
    """figure1: two restorations with similar MSE but different realism."""
    fig, axes = plt.subplots(1, 3, figsize=(13, 4.5))
    for ax, (img, name) in zip(
        axes,
        ((gt, "ground truth"),
         (blurry, f"blurry (MSE={((blurry-gt)**2).mean():.5f})"),
         (sharp, f"sharp (MSE={((sharp-gt)**2).mean():.5f})")),
    ):
        ax.imshow(img, cmap="gray"); ax.set_title(name); ax.axis("off")
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def plot_loss_curves(history: List[Dict], out_path: str,
                     keys: Optional[Sequence[str]] = None):
    """Loss-curve grid from the trainer's history rows
    (train_combined.py:347-386)."""
    if not history:
        return
    keys = keys or [k for k in history[0] if k.startswith(("loss", "g_"))]
    n = len(keys)
    cols = min(3, n)
    rows_n = -(-n // cols)
    fig, axes = plt.subplots(rows_n, cols, figsize=(5 * cols, 3.5 * rows_n), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        ax.plot([h.get(k, np.nan) for h in history])
        ax.set_title(k); ax.grid(alpha=0.3)
    for j in range(n, rows_n * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def plot_histograms(preds: Dict[str, np.ndarray], gt01: np.ndarray, out_path: str,
                    bins: int = 100):
    """Intensity histograms per model vs ground truth
    (run_ablation_studies.py:681 family)."""
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.hist(gt01.ravel(), bins=bins, histtype="step", lw=2, label="ground truth",
            color="k", density=True)
    for name, p in preds.items():
        ax.hist(p.ravel(), bins=bins, histtype="step", lw=1, label=name, density=True)
    ax.set_yscale("log"); ax.set_xlabel("intensity"); ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def plot_metric_boxplots(per_model_rows: Dict[str, list], out_path: str,
                         metrics: Tuple[str, ...] = ("psnr", "ssim", "mae", "rmse")):
    """Per-model distribution boxplots of the per-sample metrics
    (reference benchmark_tests/test_transmar_syndeeplesion.py:526-739
    boxplot family).  per_model_rows: {model: [row dicts with metric keys]}."""
    models = list(per_model_rows)
    metrics = [m for m in metrics if any(m in r for rows in per_model_rows.values() for r in rows)]
    fig, axes = plt.subplots(1, len(metrics), figsize=(3.2 * len(metrics), 4))
    if len(metrics) == 1:
        axes = [axes]
    for ax, metric in zip(axes, metrics):
        data = [[r[metric] for r in per_model_rows[m] if metric in r] for m in models]
        ax.boxplot(data, tick_labels=models, showmeans=True)
        ax.set_title(metric.upper()); ax.grid(alpha=0.3, axis="y")
        ax.tick_params(axis="x", rotation=45, labelsize=7)
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def plot_per_image_metrics(per_model_rows: Dict[str, list], out_path: str,
                           metric: str = "psnr"):
    """Per-sample metric trace, one line per model, samples on x
    (reference per-image plot family, test_transmar_syndeeplesion.py:526-739)."""
    fig, ax = plt.subplots(figsize=(9, 4))
    for name, rows in per_model_rows.items():
        xs = [r.get("sample", i) for i, r in enumerate(rows)]
        ax.plot(xs, [r[metric] for r in rows], marker="o", ms=3, lw=1, label=name)
    ax.set_xlabel("sample index"); ax.set_ylabel(metric.upper())
    ax.legend(fontsize=8); ax.grid(alpha=0.3)
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def plot_regional_comparison(regional: Dict[str, Dict[str, float]], out_path: str):
    """Bar chart of metal/band/non-metal PSNR per model
    (run_ablation_studies.py:716 family).  regional: {model: {region_PSNR}}."""
    regions = ["metal_PSNR", "band_PSNR", "non_metal_PSNR"]
    models = list(regional)
    width = 0.8 / max(len(models), 1)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    xs = np.arange(len(regions))
    for i, mname in enumerate(models):
        vals = [regional[mname].get(r, 0.0) for r in regions]
        ax.bar(xs + i * width, vals, width, label=mname)
    ax.set_xticks(xs + width * (len(models) - 1) / 2)
    ax.set_xticklabels([r.replace("_PSNR", "") for r in regions])
    ax.set_ylabel("PSNR (dB)"); ax.legend(fontsize=8); ax.grid(alpha=0.3, axis="y")
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def plot_intensity_segmentation(pred01: np.ndarray, gt01: np.ndarray, out_path: str):
    """Tissue-segmented error view (run_ablation_studies.py:999 family):
    air/soft/bone/metal segments of the gt and the per-segment MAE."""
    from tmar_torch.eval.metrics import TISSUE_RANGES

    seg = np.zeros_like(gt01)
    labels = []
    for i, (tissue, (lo, hi)) in enumerate(TISSUE_RANGES.items(), start=1):
        m = (gt01 >= lo) & (gt01 < hi)
        seg[m] = i
        err = np.abs(pred01 - gt01)[m]
        labels.append(f"{tissue}: MAE {err.mean():.4f}" if m.any() else f"{tissue}: —")
    fig, axes = plt.subplots(1, 3, figsize=(13, 4.2))
    axes[0].imshow(gt01, cmap="gray"); axes[0].set_title("gt")
    axes[1].imshow(seg, cmap="tab10", vmin=0, vmax=5); axes[1].set_title("tissue segments")
    axes[2].imshow(np.abs(pred01 - gt01), cmap="inferno"); axes[2].set_title("|err|")
    for ax in axes: ax.axis("off")
    fig.suptitle(" | ".join(labels), fontsize=8)
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def plot_artifact_waves(pred01: np.ndarray, gt01: np.ndarray, ct01: np.ndarray,
                        out_path: str, n_rings: int = 24):
    """Residual artifact energy vs distance from the metal centre
    (run_ablation_studies.py:1077 'artifact wave' family)."""
    cy, cx = find_metal_center(ct01)
    H, W = gt01.shape
    yy, xx = np.mgrid[0:H, 0:W]
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    rmax = r.max()
    edges = np.linspace(0, rmax, n_rings + 1)
    err_pred = np.abs(pred01 - gt01)
    err_in = np.abs(ct01 - gt01)
    prof_pred, prof_in = [], []
    for i in range(n_rings):
        m = (r >= edges[i]) & (r < edges[i + 1])
        prof_pred.append(err_pred[m].mean() if m.any() else 0)
        prof_in.append(err_in[m].mean() if m.any() else 0)
    centers = (edges[:-1] + edges[1:]) / 2
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(centers, prof_in, "r--", label="input artifact energy")
    ax.plot(centers, prof_pred, "b-", label="residual after restoration")
    ax.set_xlabel("distance from metal centre (px)"); ax.set_ylabel("MAE")
    ax.legend(); ax.grid(alpha=0.3)
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def plot_metric_curves(val_history: List[Dict], out_path: str):
    """Validation metric curves over epochs (run_ablation_studies.py:582)."""
    if not val_history:
        return
    keys = [k for k in val_history[0] if k.startswith("val_")]
    if not keys:
        keys = [k for k in val_history[0] if k not in ("epoch",)][:4]
    fig, axes = plt.subplots(1, max(len(keys), 1), figsize=(4.5 * max(len(keys), 1), 3.5),
                             squeeze=False)
    epochs = [h.get("epoch", i) for i, h in enumerate(val_history)]
    for ax, k in zip(axes[0], keys):
        ax.plot(epochs, [h.get(k, np.nan) for h in val_history], "o-")
        ax.set_title(k); ax.set_xlabel("epoch"); ax.grid(alpha=0.3)
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def contrast_sweep(img01: np.ndarray, out_path: str,
                   vmaxes=(0.4, 0.6, 0.8, 1.0)):
    """Display-window (vmax) sweep (reference evaluation/test_contrast.py)."""
    fig, axes = plt.subplots(1, len(vmaxes), figsize=(3.5 * len(vmaxes), 3.8))
    for ax, vm in zip(np.atleast_1d(axes), vmaxes):
        ax.imshow(img01, cmap="gray", vmin=0, vmax=vm)
        ax.set_title(f"vmax={vm}"); ax.axis("off")
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def regenerate_profiles_from_run(comparison_dir: str, dataset, out_dir: Optional[str] = None):
    """Post-hoc figure regeneration from a finished comparison run's saved
    ``sample_*.npy`` outputs (reference evaluation/generate_intensity_profiles.py):
    rebuilds intensity-profile figures + a CSV of profile data without
    re-running any model."""
    import csv
    import glob as _glob

    out_dir = out_dir or os.path.join(comparison_dir, "profiles")
    os.makedirs(out_dir, exist_ok=True)
    model_dirs = [
        d for d in sorted(os.listdir(comparison_dir))
        if os.path.isdir(os.path.join(comparison_dir, d))
        and _glob.glob(os.path.join(comparison_dir, d, "sample_*.npy"))
    ]
    if not model_dirs:
        return []
    sample_files = sorted(
        os.path.basename(p)
        for p in _glob.glob(os.path.join(comparison_dir, model_dirs[0], "sample_*.npy"))
    )
    written = []
    for fname in sample_files:
        idx = int(fname.replace("sample_", "").replace(".npy", ""))
        s = dataset[idx]
        gt01, ct01 = (s["gt"] + 1) / 2, (s["ct"] + 1) / 2
        preds = {
            d: np.load(os.path.join(comparison_dir, d, fname)) for d in model_dirs
            if os.path.exists(os.path.join(comparison_dir, d, fname))
        }
        fig_path = os.path.join(out_dir, f"profile_{idx:05d}.png")
        intensity_profiles(preds, gt01, ct01, fig_path)
        cy, cx = find_metal_center(ct01)
        csv_path = os.path.join(out_dir, f"profile_{idx:05d}.csv")
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["x", "gt", "input"] + model_dirs)
            for j in range(gt01.shape[1]):
                w.writerow(
                    [j, gt01[cy, j], ct01[cy, j]] + [preds[d][cy, j] for d in model_dirs]
                )
        written.append(fig_path)
    return written


def intensity_profiles(preds: Dict[str, np.ndarray], gt01: np.ndarray,
                       ct01: np.ndarray, out_path: str):
    """Horizontal + vertical line profiles through the metal centre
    (generate_intensity_profiles.py)."""
    cy, cx = find_metal_center(ct01)
    fig, axes = plt.subplots(1, 2, figsize=(14, 4.5))
    for ax, (axis_name, take) in zip(
        axes,
        (("horizontal", lambda a: a[cy, :]), ("vertical", lambda a: a[:, cx])),
    ):
        ax.plot(take(gt01), "k-", lw=2, label="ground truth")
        ax.plot(take(ct01), "r:", lw=1, label="corrupted")
        for name, p in preds.items():
            ax.plot(take(p), lw=1, label=name)
        ax.set_title(f"{axis_name} profile through metal centre ({cy},{cx})")
        ax.legend(fontsize=7); ax.grid(alpha=0.3)
    fig.tight_layout(); fig.savefig(out_path, dpi=150); plt.close(fig)


def zoom_box(ct01: np.ndarray, size: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(y1, y2, x1, x2) crop box centred on the metal region (reference
    builds zoom coords around find_metal_center, :1465-1490)."""
    h, w = ct01.shape
    if size is None:
        size = max(h // 4, 32)
    cy, cx = find_metal_center(ct01)
    y1 = int(np.clip(cy - size // 2, 0, h - size))
    x1 = int(np.clip(cx - size // 2, 0, w - size))
    return y1, y1 + size, x1, x1 + size


def composite_figure(
    corrupted01: np.ndarray,
    gt01: np.ndarray,
    outputs: Dict[str, np.ndarray],
    save_path: str,
    zoom_coords: Optional[Tuple[int, int, int, int]] = None,
):
    """Multi-model composite with zoomed metal crops (reference
    create_composite_figure, benchmark_comparison_syndeeplesion.py:957-1087):
    2 columns (full | zoom), rows = corrupted (red box), GT (green), then one
    green-boxed row per model; all images share the GT-derived gray window.
    """
    from matplotlib.patches import Rectangle

    if zoom_coords is None:
        zoom_coords = zoom_box(corrupted01)
    y1, y2, x1, x2 = zoom_coords
    zoom_h, zoom_w = y2 - y1, x2 - x1
    margin = max(zoom_h // 8, 1)

    gt_disp = np.clip(gt01, 0, 1)
    vmax = float(min(max(np.percentile(gt_disp, 99.5), 0.5), 1.0))
    rows = [("corrupted", np.clip(corrupted01, 0, 1), "red"),
            ("ground_truth", gt_disp, "lime")]
    rows += [(name, np.clip(img, 0, 1), "lime") for name, img in outputs.items()]

    fig, axes = plt.subplots(len(rows), 2, figsize=(4, 1.8 * len(rows)),
                             squeeze=False)
    for r, (_, img, color) in enumerate(rows):
        axes[r][0].imshow(img, cmap="gray", vmin=0.0, vmax=vmax)
        axes[r][0].add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       linewidth=2, edgecolor=color,
                                       facecolor="none"))
        axes[r][1].imshow(img[y1:y2, x1:x2], cmap="gray", vmin=0.0, vmax=vmax)
        axes[r][1].add_patch(Rectangle((margin, margin),
                                       zoom_w - 2 * margin, zoom_h - 2 * margin,
                                       linewidth=2, edgecolor=color,
                                       facecolor="none"))
        for c in (0, 1):
            axes[r][c].axis("off")
            axes[r][c].set_aspect("equal")
    plt.subplots_adjust(left=0, right=1, top=1, bottom=0, wspace=0.01,
                        hspace=0.01)
    fig.savefig(save_path, dpi=200, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
