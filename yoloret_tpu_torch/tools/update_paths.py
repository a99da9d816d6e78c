"""Rewrite image-path prefixes inside annotation lists — the
``update_voc_path.py`` / ``update_coco_path.py`` utilities
(reference: code/update_voc_path.py:1-17, code/update_coco_path.py:1-17).
A copy of the JAX package's ``yoloret_tpu/tools/update_paths.py`` on the
port's ``data/annotations.py``.

    python -m yoloret_tpu_torch.tools.update_paths OLD_PREFIX NEW_PREFIX LIST...

Writes each rewritten list next to the original with a ``.rewritten``
suffix unless --in-place is given.
"""

from __future__ import annotations

import argparse

from yoloret_tpu_torch.data.annotations import rewrite_image_paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("old_prefix")
    p.add_argument("new_prefix")
    p.add_argument("lists", nargs="+")
    p.add_argument("--in-place", action="store_true")
    a = p.parse_args(argv)
    for path in a.lists:
        with open(path) as f:
            lines = [l.rstrip("\n") for l in f if l.strip()]
        out = rewrite_image_paths(lines, a.old_prefix, a.new_prefix)
        dest = path if a.in_place else path + ".rewritten"
        with open(dest, "w") as f:
            f.write("\n".join(out) + "\n")
        print(f"{path} -> {dest} ({len(out)} lines)")


if __name__ == "__main__":
    main()
