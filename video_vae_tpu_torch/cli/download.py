"""OpenVid-1M dataset fetcher.

Counterpart of the JAX package's ``cli/download.py``: it fetches the split
zip archives from the Hugging Face Hub, joins multi-part archives
(``partaa``, ``partab``, ``partac``), and extracts the videos of shard ``i``
into ``videos{i}/``. It needs ``huggingface_hub`` and network access; without
the package it says so and exits. It touches no device, so it takes no
``--device``.

    python -m video_vae_tpu_torch.cli.download --out_dir /data --shards 0 1 2
"""

from __future__ import annotations

import argparse
import os
import zipfile

REPO_ID = "nkp37/OpenVid-1M"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Download OpenVid-1M video shards")
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--shards", type=int, nargs="+", default=[0])
    parser.add_argument("--keep_zips", action="store_true")
    args = parser.parse_args(argv)

    try:
        from huggingface_hub import hf_hub_download
    except ImportError:
        raise SystemExit(
            "[download] huggingface_hub is not installed in this environment; "
            "install it (and ensure network egress) to fetch OpenVid-1M."
        )

    os.makedirs(args.out_dir, exist_ok=True)
    for shard in args.shards:
        zip_name = f"OpenVid_part{shard}.zip"
        print(f"[download] fetching {zip_name}")
        try:
            zip_path = hf_hub_download(
                repo_id=REPO_ID, filename=zip_name, repo_type="dataset",
                local_dir=args.out_dir,
            )
        except Exception:
            # large shards are split into partaa/partab/...: fetch and concatenate
            parts = []
            for suffix in ("aa", "ab", "ac"):
                try:
                    parts.append(
                        hf_hub_download(
                            repo_id=REPO_ID,
                            filename=f"OpenVid_part{shard}_part{suffix}",
                            repo_type="dataset",
                            local_dir=args.out_dir,
                        )
                    )
                except Exception:
                    break
            if not parts:
                print(f"[download] shard {shard} unavailable; skipping")
                continue
            zip_path = os.path.join(args.out_dir, zip_name)
            with open(zip_path, "wb") as out:
                for part in parts:
                    with open(part, "rb") as f:
                        while chunk := f.read(1 << 24):
                            out.write(chunk)
                    if not args.keep_zips:
                        os.remove(part)
        target = os.path.join(args.out_dir, f"videos{shard}")
        os.makedirs(target, exist_ok=True)
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(target)
        if not args.keep_zips:
            os.remove(zip_path)
        print(f"[download] extracted shard {shard} → {target}")


if __name__ == "__main__":
    main()
