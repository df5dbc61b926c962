"""Training-manifest tooling: build/validate the train CSV (the port's
own copy of ``milnce_tpu/data/manifest.py``).

The reference trains from ``csv/all_videos.csv`` / ``csv/howto100m_videos.csv``
(video_loader.py:27, args_small.py:5) but ships neither (stripped as large
blobs); a user standing up training must produce a manifest themselves.
This CLI builds one from a video tree and validates it against the
caption store:

    python -m milnce_tpu_torch.data.manifest build /data/videos --out train.csv
    python -m milnce_tpu_torch.data.manifest validate train.csv \
        --video_root /data/videos --caption_root /data/caption_json

Schema: one ``video_path`` column, paths relative to ``video_root``
(exactly what HowTo100MSource reads, data/datasets.py).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

VIDEO_EXTS = (".mp4", ".mkv", ".webm", ".avi")


def build(video_root: str, out: str, caption_root: str = "",
          exts=VIDEO_EXTS) -> tuple[int, int]:
    """Scan ``video_root`` recursively; write relative paths of every
    video file.  With ``caption_root``, only videos whose ``<id>.json``
    caption track exists are listed.  Returns (written, skipped)."""
    rows, skipped = [], 0
    for dirpath, _, files in os.walk(video_root):
        for name in sorted(files):
            if not name.lower().endswith(exts):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), video_root)
            if caption_root:
                vid = os.path.basename(name).rsplit(".", 1)[0]
                if not os.path.exists(os.path.join(caption_root,
                                                   vid + ".json")):
                    skipped += 1
                    continue
            rows.append(rel)
    rows.sort()
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_path"])
        for rel in rows:
            w.writerow([rel])
    return len(rows), skipped


def validate(manifest: str, video_root: str = "",
             caption_root: str = "") -> dict:
    """Check every row: file exists (when video_root given), caption JSON
    parses with start/end/text keys (when caption_root given)."""
    from milnce_tpu_torch.data.datasets import read_csv

    rows = read_csv(manifest)
    report = {"rows": len(rows), "missing_video": 0, "missing_captions": 0,
              "bad_captions": 0}
    if not rows or "video_path" not in rows[0]:
        raise ValueError(f"{manifest}: no video_path column")
    for row in rows:
        rel = row["video_path"]
        if video_root and not os.path.exists(os.path.join(video_root, rel)):
            report["missing_video"] += 1
        if caption_root:
            vid = os.path.basename(rel).rsplit(".", 1)[0]
            cap = os.path.join(caption_root, vid + ".json")
            if not os.path.exists(cap):
                report["missing_captions"] += 1
                continue
            try:
                with open(cap) as fh:
                    data = json.load(fh)
            except (OSError, ValueError):
                data = {}
            if not (isinstance(data, dict)
                    and {"start", "end", "text"} <= set(data)):
                report["bad_captions"] += 1
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description="milnce-tpu-torch manifest tool")
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build")
    b.add_argument("video_root")
    b.add_argument("--out", required=True)
    b.add_argument("--caption_root", default="")
    v = sub.add_parser("validate")
    v.add_argument("manifest")
    v.add_argument("--video_root", default="")
    v.add_argument("--caption_root", default="")
    args = p.parse_args(argv)
    if args.cmd == "build":
        n, skipped = build(args.video_root, args.out, args.caption_root)
        print(f"wrote {args.out}: {n} videos"
              + (f" ({skipped} skipped, no captions)" if skipped else ""))
    else:
        rep = validate(args.manifest, args.video_root, args.caption_root)
        print(json.dumps(rep))
        if rep["missing_video"] or rep["bad_captions"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
