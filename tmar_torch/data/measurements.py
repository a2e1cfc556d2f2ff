"""Quick-look viewer for saved result images (the counterpart of
``tmar.data.measurements``): pick the first image in a results directory and
display it, or save a titled copy where there is no display.  Usage:
``python -m tmar_torch.data.measurements [dir]``.
"""

from __future__ import annotations

import os
import sys
from typing import Optional


def show_first_result(
    results_dir: str = "./test_results", save_to: Optional[str] = None
) -> Optional[str]:
    """Display (or re-save with a title) the first image file found.

    Returns the path of the file shown, or None if the directory holds no
    images.  Headless hosts get a saved copy instead of a window.
    """
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
    if not os.path.isdir(results_dir):
        print(f"No results directory: {results_dir}")
        return None
    files = sorted(
        f
        for f in os.listdir(results_dir)
        if f.lower().endswith(exts) and f != "_first_result_view.png"
    )
    if not files:
        print(f"No results found in {results_dir}.")
        return None
    path = os.path.join(results_dir, files[0])

    import matplotlib

    if save_to is not None or not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = plt.imread(path)
    plt.figure(figsize=(8, 8))
    plt.imshow(img, cmap="gray")
    plt.axis("off")
    plt.title("Generated CT Image Result")
    if save_to is not None or not os.environ.get("DISPLAY"):
        save_to = save_to or os.path.join(results_dir, "_first_result_view.png")
        plt.savefig(save_to, bbox_inches="tight")
        plt.close()
        print(f"Saved view of {path} to {save_to}")
    else:  # pragma: no cover - needs a display
        plt.show()
    return path


if __name__ == "__main__":
    show_first_result(sys.argv[1] if len(sys.argv) > 1 else "./test_results")
