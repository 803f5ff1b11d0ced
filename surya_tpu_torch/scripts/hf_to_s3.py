"""Maintainer utility: mirror a HuggingFace checkpoint into the S3-compatible
weight bucket with the manifest the loaders expect (counterpart of
surya_tpu/scripts/hf_to_s3.py, on argparse like the port's other CLIs;
reference: surya/scripts/hf_to_s3.py). boto3 / huggingface_hub are optional
deps, imported when it runs.

    python -m surya_tpu_torch.scripts.hf_to_s3 <hf_repo_id> <s3_path> [--suffix S]

The files go to ``<s3_path>/<YYYY_MM_DD>[_<suffix>]/`` beside a
``manifest.json`` that lists them, which common/s3.py reads to fetch them.
"""

from __future__ import annotations

import argparse
import datetime
import json
import shutil
import tempfile
from pathlib import Path
from typing import Optional, Sequence

S3_API_URL = "https://1afbe4656a6b40d982ab5e730a39f6b9.r2.cloudflarestorage.com"


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Upload a HuggingFace checkpoint to the S3 weight bucket.")
    ap.add_argument("hf_repo_id")
    ap.add_argument("s3_path")
    ap.add_argument("--bucket_name", default="datalab")
    ap.add_argument("--access_key_id", default="<access_key_id>")
    ap.add_argument("--access_key_secret", default="<access_key_secret>")
    ap.add_argument("--suffix", default="")
    args = ap.parse_args(argv)
    try:
        import boto3
        from huggingface_hub import snapshot_download
        from tqdm import tqdm
    except ImportError as e:
        raise ImportError("hf_to_s3 needs boto3 and huggingface_hub") from e

    curr_date = datetime.datetime.now().strftime("%Y_%m_%d")
    s3_path = f"{args.s3_path}/{curr_date}"
    if args.suffix:
        s3_path = f"{s3_path}_{args.suffix}"

    # stage into a temp dir: the snapshot lives inside the shared HF hub
    # cache (symlinked blobs) — writing the manifest there or deleting it
    # would corrupt the cache for other consumers
    download_folder = Path(snapshot_download(repo_id=args.hf_repo_id))
    with tempfile.TemporaryDirectory() as tmp:
        staging = Path(tmp)
        for f in download_folder.glob("*"):
            if f.is_file():
                shutil.copyfile(f, staging / f.name)
        contained_files = [f.name for f in staging.glob("*")]
        # the manifest drives the loaders' parallel fetch (common/s3.py)
        with open(staging / "manifest.json", "w") as fh:
            json.dump({"files": contained_files}, fh)

        s3_client = boto3.client(
            service_name="s3",
            endpoint_url=S3_API_URL,
            aws_access_key_id=args.access_key_id,
            aws_secret_access_key=args.access_key_secret,
            region_name="auto",
        )
        for file_path in tqdm(staging.glob("*"), desc="Uploading files", unit="file"):
            try:
                s3_client.upload_file(str(file_path), args.bucket_name, f"{s3_path}/{file_path.name}")
            except Exception as e:
                print(f"Error uploading {file_path}: {e}")
    print(f"Uploaded files to {s3_path}")


if __name__ == "__main__":
    main()
