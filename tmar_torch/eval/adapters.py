"""Third-party model adapters for the benchmark comparison harness (the
counterpart of ``tmar.eval.adapters``).

* ``enrich_sample`` builds the benchmark sample dict
  ``{Xma, Xgt, XLI, Mask, Sma, SLI, Tr}``; the sinograms come from the
  port's Radon operator (``tmar_torch.ops.radon``) on its device, under
  ``torch.no_grad()``, so dual-domain adapters work on any dataset.
* Runner factories, one per preprocessing protocol:
  - ``make_neg11_runner``: the NGswin family's [-1, 1] protocol;
  - ``make_x255_runner``: the DICDNet / FIND-Net x255 protocol;
  - ``make_nmar_runner``: the InDuDoNet+ NMAR-prior protocol;
  - ``make_sparse_view_runner``: the MEPNet sparse-view FBP protocol;
  - ``make_dudo_runner``: the in-tree dual-domain net (``nn/dudo.py``).
  A runner maps the enriched sample dict -> [H, W] prediction in [0, 1].
* ``SubprocessAdapter`` / ``SubprocessCore``: an external model in its own
  process.  They write the same ``.npz`` inputs and read the same ``.npy``
  output as the JAX package's, so the same external commands work.

Image-domain quantities are [0, 1]-normalised CT; the sinogram window for
the x255 protocols is (0, 4).
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Callable, Dict, Optional, Sequence

import numpy as np

IMAGE_MINMAX = (0.0, 1.0)
PROJ_MINMAX = (0.0, 4.0)


def _on_radon(radon, fn_name: str, arrays: np.ndarray) -> np.ndarray:
    """``radon.<fn_name>`` on a numpy batch, on the operator's device, with
    autograd off; the result back as numpy."""
    import torch

    with torch.no_grad():
        t = torch.from_numpy(np.ascontiguousarray(arrays, dtype=np.float32)).to(radon.device)
        return getattr(radon, fn_name)(t).cpu().numpy()


# ------------------------------------------------------------- enrichment

def enrich_sample(
    sample: Dict[str, np.ndarray],
    radon=None,
    metal_threshold: float = 0.6,
) -> Dict[str, np.ndarray]:
    """{ct, gt, li} in [-1,1] -> the benchmark dict (all [0,1]).

    Mask is the binary metal mask of the artifact image at the 0.6
    threshold in [-1,1] space; Sma/SLI are parallel-beam sinograms of
    Xma/XLI and Tr the metal trace (Radon(Mask) > 0), synthesized when a
    ``radon`` operator is given.
    """
    ct = np.asarray(sample["ct"], np.float32)
    gt = np.asarray(sample["gt"], np.float32)
    li = np.asarray(sample.get("li", sample["ct"]), np.float32)
    out: Dict[str, np.ndarray] = {
        "Xma": np.clip((ct + 1) / 2, 0, 1),
        "Xgt": np.clip((gt + 1) / 2, 0, 1),
        "XLI": np.clip((li + 1) / 2, 0, 1),
        "Mask": (ct > metal_threshold).astype(np.float32),
    }
    if radon is not None:
        sinos = _on_radon(radon, "forward", np.stack([out["Xma"], out["XLI"], out["Mask"]]))
        out["Sma"], out["SLI"] = sinos[0], sinos[1]
        out["Tr"] = (sinos[2] > 0).astype(np.float32)
        out["has_sinogram"] = True
    else:
        out["Sma"] = out["SLI"] = out["Tr"] = None
        out["has_sinogram"] = False
    return out


def _norm255_img(x01: np.ndarray) -> np.ndarray:
    lo, hi = IMAGE_MINMAX
    return (np.clip(x01, lo, hi) * 255.0).astype(np.float32)


def _norm255_sino(sino: np.ndarray) -> np.ndarray:
    lo, hi = PROJ_MINMAX
    return ((np.clip(sino, lo, hi) - lo) / (hi - lo) * 255.0).astype(np.float32)


def _post_half(out255: np.ndarray) -> np.ndarray:
    """clamp(out/255, 0, 0.5)/0.5: the FIND-Net / InDuDoNet / MEPNet
    post-processing."""
    return np.clip(np.asarray(out255, np.float32) / 255.0, 0.0, 0.5) / 0.5


def _post_div255(out255: np.ndarray) -> np.ndarray:
    """out/255 clipped to [0,1]: the DICDNet post-processing."""
    return np.clip(np.asarray(out255, np.float32) / 255.0, 0.0, 1.0)


# ---------------------------------------------------------------- runners

def make_neg11_runner(forward: Callable[[np.ndarray], np.ndarray]):
    """NGswin-family protocol: clip Xma to [0,1], scale to [-1,1], forward,
    (out+1)/2.  ``forward``: [B,H,W,1] in [-1,1] -> [B,H,W,1] in [-1,1]."""

    def run(sample: Dict[str, np.ndarray]) -> np.ndarray:
        x = np.clip(sample["Xma"].astype(np.float32), 0, 1) * 2 - 1
        out = np.asarray(forward(x[None, ..., None]))[0, ..., 0]
        return np.clip((out + 1) / 2, 0, 1)

    return run


def make_x255_runner(
    core: Callable[[np.ndarray, np.ndarray, np.ndarray], np.ndarray],
    postprocess: str = "div255",
):
    """DICDNet / FIND-Net protocol: inputs x255, non-metal mask.
    ``core(Xma255, XLI255, non_mask)`` -> out255 [H, W].  postprocess:
    'div255' (DICDNet) or 'half' (FIND-Net's clamp-to-0.5/0.5)."""
    post = {"div255": _post_div255, "half": _post_half}[postprocess]

    def run(sample: Dict[str, np.ndarray]) -> np.ndarray:
        xma = _norm255_img(sample["Xma"])
        xli = _norm255_img(sample["XLI"])
        non_mask = 1.0 - sample["Mask"].astype(np.float32)
        return post(core(xma, xli, non_mask))

    return run


def make_nmar_runner(core: Callable[..., np.ndarray]):
    """InDuDoNet+ protocol: the NMAR tissue prior of the LI image (k-means
    thresholds, miu_water = 0.192 in [0,1] units) BEFORE normalisation, then
    x255 images / sinograms and the inverted trace.
    ``core(Xma255, XLI255, Sma255, SLI255, Tr, Xprior255)`` -> out255.
    Needs an enriched sample with sinograms."""

    def run(sample: Dict[str, np.ndarray]) -> np.ndarray:
        from tmar_torch.ops.nmar import nmar_prior

        if sample.get("Sma") is None:
            raise ValueError("nmar runner needs sinograms; enrich with a Radon operator")
        # the prior fills with water where its valid mask is < 0.5: pass the
        # non-metal mask
        non_metal = 1.0 - (sample["Mask"] > 0.5).astype(np.float32)
        prior01 = nmar_prior(sample["XLI"][None], non_metal[None],
                             miu_air=0.0, miu_water=0.192)[0]
        tr = 1.0 - sample["Tr"].astype(np.float32)
        return _post_half(core(
            _norm255_img(sample["Xma"]), _norm255_img(sample["XLI"]),
            _norm255_sino(sample["Sma"]), _norm255_sino(sample["SLI"]),
            tr, _norm255_img(prior01),
        ))

    return run


def make_dudo_runner(model, params=None, radon=None, li_mode: str = "train"):
    """The in-tree dual-domain net (``tmar_torch.nn.dudo.DuDoMARNet``):
    [0,1]-scale images, raw-scale sinograms, the NON-metal trace, the
    conventions of the fine-tune engine, so a fine-tuned net drops straight
    into the harness.  ``params`` is the flax tree that ``finetune --arch
    dudo`` pickles (read by ``checkpoint.module_from_flax`` into ``model``);
    None keeps the model's own weights.

    ``li_mode``: ``"train"`` rebuilds XLI/SLI with the fine-tune engine's
    mean-fill construction (``data.finetune.create_li_image``; needs
    ``radon`` for SLI); ``"sample"`` trusts the enriched sample's XLI/SLI.
    Needs an enriched sample with sinograms."""
    import torch

    if li_mode not in ("train", "sample"):
        raise ValueError(f"li_mode must be 'train' or 'sample', got {li_mode!r}")
    if li_mode == "train" and radon is None:
        raise ValueError("li_mode='train' rebuilds SLI and needs a radon operator")
    if params is not None:
        from tmar_torch.checkpoint.convert import module_from_flax

        model.load_state_dict(module_from_flax(model, params))
    model.eval()
    dev = next(model.parameters()).device

    def run(sample: Dict[str, np.ndarray]) -> np.ndarray:
        if sample.get("Sma") is None:
            raise ValueError("dudo runner needs sinograms; enrich with a Radon operator")
        xma = np.clip(sample["Xma"].astype(np.float32), 0, 1)[None, ..., None]
        if li_mode == "train":
            from tmar_torch.data.finetune import create_li_image

            li01 = create_li_image(np.clip(sample["Xma"].astype(np.float32), 0, 1),
                                   (sample["Mask"] > 0.5).astype(np.float32))
            sample = dict(sample, XLI=li01, SLI=_on_radon(radon, "forward", li01[None])[0])
        xli = np.clip(sample["XLI"].astype(np.float32), 0, 1)[None, ..., None]
        m = (1.0 - (sample["Mask"] > 0.5).astype(np.float32))[None, ..., None]
        sma = sample["Sma"].astype(np.float32)[None]
        sli = sample["SLI"].astype(np.float32)[None]
        tr = (1.0 - (sample["Tr"] > 0).astype(np.float32))[None]  # non-metal = 1
        with torch.no_grad():
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (xma, xli, m, sma, sli, tr)]
            out = model(*args)["x"].float().cpu().numpy()
        return np.clip(out[0, ..., 0], 0.0, 1.0)

    return run


def make_sparse_view_runner(core: Callable[..., np.ndarray], radon, factor: int = 2):
    """MEPNet V-(A/factor) protocol: zero all but every ``factor``-th
    projection angle, FBP-reconstruct the sparse-view images, and build the
    data-consistency trace TrDC = 1 - (Tr | dropped angles).
    ``core(Xma255, XLI255, Mask, Sma255, SLI255, TrDC)`` -> out255."""

    def run(sample: Dict[str, np.ndarray]) -> np.ndarray:
        if sample.get("Sma") is None:
            raise ValueError("sparse-view runner needs sinograms")
        sma, sli = sample["Sma"], sample["SLI"]
        d = np.zeros_like(sma)
        d[::factor, :] = 1.0
        sma_sp = d * sma
        sli_sp = d * sli
        recon = _on_radon(radon, "fbp", np.stack([sma_sp, sli_sp]))  # [2, H, W]
        xma_sp, xli_sp = np.clip(recon[0], 0, 1), np.clip(recon[1], 0, 1)
        tr_dc = 1.0 - np.logical_or(sample["Tr"] > 0, d == 0).astype(np.float32)
        return _post_half(core(
            _norm255_img(xma_sp), _norm255_img(xli_sp), sample["Mask"].astype(np.float32),
            _norm255_sino(sma_sp), _norm255_sino(sli_sp), tr_dc,
        ))

    return run


# --------------------------------------------------- out-of-process models

def _run_subprocess(cmd, arrays: Dict[str, np.ndarray], workdir, timeout, what: str,
                    prefix: str) -> np.ndarray:
    """Write ``arrays`` to ``<tmp>/input.npz``, run ``cmd + [input, output]``
    and load ``<tmp>/output.npy``; a non-zero exit raises with the tail of
    the command's output."""
    with tempfile.TemporaryDirectory(prefix=prefix) as td:
        in_path = os.path.join(td, "input.npz")
        out_path = os.path.join(td, "output.npy")
        np.savez(in_path, **arrays)
        proc = subprocess.run(
            list(cmd) + [in_path, out_path], cwd=workdir, timeout=timeout,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{what} subprocess failed (rc={proc.returncode}):\n"
                               + proc.stdout[-2000:])
        return np.load(out_path)


class SubprocessAdapter:
    """Out-of-process adapter: an external model in its own interpreter.

    The enriched sample dict is written to ``<tmp>/input.npz`` (keys
    Xma/Xgt/XLI/Mask and, when present, Sma/SLI/Tr; all float32);
    ``cmd + [input_path, output_path]`` runs; the command writes the [H, W]
    prediction in [0, 1] to ``output_path`` (``.npy``).  A crash is
    contained to a FAILED row.
    """

    def __init__(self, cmd, workdir: Optional[str] = None, timeout: float = 600.0):
        self.cmd = list(cmd)
        self.workdir = workdir
        self.timeout = timeout

    def __call__(self, sample: Dict[str, np.ndarray]) -> np.ndarray:
        arrays = {k: np.asarray(v, np.float32) for k, v in sample.items()
                  if isinstance(v, np.ndarray)}
        pred = _run_subprocess(self.cmd, arrays, self.workdir, self.timeout, "adapter",
                               "tmar_adapter_")
        if pred.ndim != 2:
            pred = np.squeeze(pred)
        return np.clip(pred.astype(np.float32), 0, 1)


class SubprocessCore:
    """Out-of-process CORE for a protocol runner (``make_x255_runner`` /
    ``make_sparse_view_runner`` / ``make_nmar_runner``): the harness-side
    runner does the protocol's normalisation and post-processing, and only
    the model core crosses the process boundary.  The positional arrays the
    runner passes are written to ``input.npz`` under ``keys``; the command
    returns the protocol-domain output (e.g. x255) unclipped."""

    def __init__(self, cmd, keys: Sequence[str], workdir: Optional[str] = None,
                 timeout: float = 600.0):
        self.cmd = list(cmd)
        self.keys = tuple(keys)
        self.workdir = workdir
        self.timeout = timeout

    def __call__(self, *arrays: np.ndarray) -> np.ndarray:
        if len(arrays) != len(self.keys):
            raise ValueError(f"protocol core expected {len(self.keys)} arrays "
                             f"({self.keys}), got {len(arrays)}")
        out = _run_subprocess(self.cmd, {k: np.asarray(v, np.float32)
                                         for k, v in zip(self.keys, arrays)},
                              self.workdir, self.timeout, "protocol-core", "tmar_core_")
        return np.squeeze(out).astype(np.float32)


#: npz key layout each protocol's positional core arguments are written
#: under when the core runs out of process (SubprocessCore)
PROTOCOL_CORE_KEYS = {
    "x255": ("Xma255", "XLI255", "non_mask"),
    "x255half": ("Xma255", "XLI255", "non_mask"),
    "sparse": ("Xma255", "XLI255", "Mask", "Sma255", "SLI255", "TrDC"),
    "nmar": ("Xma255", "XLI255", "Sma255", "SLI255", "Tr", "Xprior255"),
}


def make_protocol_subprocess_runner(protocol: str, cmd, radon=None, sparse_factor: int = 2):
    """An out-of-process model core inside one of the preprocessing
    protocols: ``x255`` (DICDNet ÷255 post), ``x255half`` (FIND-Net
    clamp-to-0.5 post), ``sparse`` (MEPNet sparse-view FBP; needs
    ``radon``), ``nmar`` (InDuDoNet+ NMAR prior).  ``raw`` is not here: that
    is plain :class:`SubprocessAdapter`."""
    try:
        keys = PROTOCOL_CORE_KEYS[protocol]
    except KeyError:
        raise ValueError(f"unknown adapter protocol {protocol!r} "
                         f"(one of {sorted(PROTOCOL_CORE_KEYS)} or raw)") from None
    core = SubprocessCore(cmd, keys)
    if protocol == "x255":
        return make_x255_runner(core, postprocess="div255")
    if protocol == "x255half":
        return make_x255_runner(core, postprocess="half")
    if protocol == "sparse":
        if radon is None:
            raise ValueError("sparse protocol needs a radon operator (compare --sinograms)")
        return make_sparse_view_runner(core, radon, factor=sparse_factor)
    return make_nmar_runner(core)
