"""Time K2 and K3/K3q with their launch rules replaced by fixed choices.

The rules that pick a kernel's launch from its shapes (``causal_launch`` in
``surya_tpu_torch/csrc/flash_attn.cu``: K2's row blocks an item and CTAs;
``decode_cluster_size`` in ``csrc/decode_attn.cu``: K3's CTAs a (slot, kv
head)) take no argument that overrides them. To time the choices they did
not make, this script copies the port once for each variant into
``compare/variants/<name>/`` (gitignored), with the rule's function
returning that variant's choice, and runs ``chip_smoke.py --kernels --tree``
on each copy and on this tree (first and last), one process each, in turn.
Every kernel output is still held against its plain version there. It
prints one ``VARIANTS`` JSON line, {tree: {case: ms}}, and keeps each
process's output under ``chiprun_out/kernel_variants/``.

    python3 kernel_variants.py [--clusters 1,2,3,4,6,8]

Runs only where CUDA is available (the H100); exits non-zero elsewhere and
when any run fails.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DECODE_RULE = "int decode_cluster_size(int B, int KVH, int S, int K) {"
CAUSAL_RULE = "static CausalLaunch causal_launch(int B, int L, int KVH) {"
# K2's choices: every (batch row, kv head) one item of all its row blocks and
# a CTA each (where its tiles stay resident), and one 64-row block an item
CAUSAL_VARIANTS = {
    "K2 one item a CTA": "{ const int nb = (L + BLOCK - 1) / BLOCK; "
                         "if (2 * nb <= CAUSAL_STAGES) return CausalLaunch{nb, B * KVH}; }",
    "K2 one row block an item": "return CausalLaunch{1, (L + BLOCK - 1) / BLOCK * B * KVH};",
}


def make_variant(name: str, source: str, rule: str, body: str) -> Path:
    """A copy of the port whose csrc/<source> runs `body` first in `rule`."""
    tree = ROOT / "compare" / "variants" / name.replace(" ", "_")
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "surya_tpu_torch", tree / "surya_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tree / "surya_tpu_torch" / "csrc" / source
    text = path.read_text()
    if text.count(rule) != 1:
        raise SystemExit(f"kernel_variants.py: {source} does not hold `{rule}` once")
    path.write_text(text.replace(rule, f"{rule}\n  {body}"))
    return tree


def run(tree: Path | None, log_dir: Path) -> dict:
    """chip_smoke.py --kernels on this tree (None) or a copy; its times."""
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--kernels"] + (["--tree", str(tree)] if tree else [])
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=900)
    name = tree.name if tree else "this_tree"
    (log_dir / f"{name}.log").write_text(out.stdout + out.stderr)
    line = next((x for x in out.stdout.splitlines() if x.startswith("KERNELS_AB ")), None)
    if out.returncode or line is None:
        sys.stdout.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"kernel_variants.py: the run of {name} failed ({out.returncode})")
    return json.loads(line[len("KERNELS_AB "):])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clusters", default="1,2,3,4,6,8", help="CTAs a (slot, kv head) to time K3 and K3q with")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants.py: no CUDA device; this script runs only on the GPU")
    log_dir = ROOT / "chiprun_out" / "kernel_variants"
    log_dir.mkdir(parents=True, exist_ok=True)
    trees = {f"K3 clusters of {c}": make_variant(f"K3 clusters of {c}", "decode_attn.cu", DECODE_RULE, f"return {c};")
             for c in map(int, args.clusters.split(","))}
    trees.update({name: make_variant(name, "flash_attn.cu", CAUSAL_RULE, body)
                  for name, body in CAUSAL_VARIANTS.items()})
    times = {"this tree": run(None, log_dir)["ms"]}
    card = None
    for name, tree in trees.items():
        res = run(tree, log_dir)
        times[name], card = res["ms"], res["card"]
    times["this tree, again"] = run(None, log_dir)["ms"]
    print("VARIANTS " + json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()
