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

With ``--k1`` it times K1 instead, against copies whose consumer
warpgroups skip every product and only take and free the tiles (``K1_EDITS``):
what the copies and the item walk alone cost, and of that what the 32-byte
boxes (dims 64..79) cost. Their outputs are not attention and are not held;
each tree is timed in a process of its own (``--k1-times``) at
``chip_smoke.py --kernels``'s K1 shapes, this tree first and last.

    python3 kernel_variants.py --k1

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


# K1's consumers: the line that starts an item's tiles, and what the
# load-only copies put there instead (every tile taken and freed, the Q
# buffer freed, no product, no store); and the 32-byte boxes' loads, which
# the second copy also drops
K1_TILES = "    for (int t = 0; t < t_first; ++t) pass(step + t);\n"
K1_LOADS_ONLY = (K1_TILES, """    for (int t = 0; t < n_tiles; ++t) pass(step + t);
    if (leader && j > 0) mbar_arrive(&sm.q_empty[(j - 1) % SEG_QBUF]);
    mbar_wait(&sm.q_full[j % SEG_QBUF], (j / SEG_QBUF) & 1);
    step += n_tiles;
    continue;
""" + K1_TILES)
K1_NO_B_BOXES = [
    ("        tma_load_3d(sm.k_b[s], &k_b_map, &sm.k_full[s], 64, head, row);\n", ""),
    ("        tma_load_3d(sm.v_b[s], &v_b_map, &sm.v_full[s], 64, head, row);\n", ""),
    ("        mbar_expect_tx(&sm.k_full[s], SEG_TILE_BYTES);\n", "        mbar_expect_tx(&sm.k_full[s], SEG_A_ELEMS * 2);\n"),
    ("        mbar_expect_tx(&sm.v_full[s], SEG_TILE_BYTES);\n", "        mbar_expect_tx(&sm.v_full[s], SEG_A_ELEMS * 2);\n"),
]
K1_EDITS = {
    "K1 loads only": [K1_LOADS_ONLY],
    "K1 loads only, 64-dim boxes only": [K1_LOADS_ONLY] + K1_NO_B_BOXES,
}


def copy_port(name: str, source: str, edits) -> Path:
    """A copy of the port whose csrc/<source> has each (old, new) of
    `edits` applied; each old must occur once."""
    tree = ROOT / "compare" / "variants" / name.replace(" ", "_")
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "surya_tpu_torch", tree / "surya_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tree / "surya_tpu_torch" / "csrc" / source
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"kernel_variants.py: {source} does not hold `{old.strip()}` once")
        text = text.replace(old, new)
    path.write_text(text)
    return tree


def make_variant(name: str, source: str, rule: str, body: str) -> Path:
    """A copy of the port whose csrc/<source> runs `body` first in `rule`."""
    return copy_port(name, source, [(rule, f"{rule}\n  {body}")])


def k1_times() -> None:
    """--k1-times [--tree DIR]: K1's device time at chip_smoke.py --kernels's
    shapes (16 pages of given lines: full-attention and windowed blocks)
    and on its edge layout, unheld; prints one K1_TIMES JSON line."""
    import numpy as np
    import torch

    import chip_smoke as cs

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    grids = [(h // 14, w // 14) for h, w in cs.LINE_SHAPES] * 16
    cap = 4096
    while cap < sum(a * b for a, b in grids):
        cap *= 2
    plan = cs.plan_layout(grids, cs.EncoderConfig(**cs.DEFAULT_ENCODER), cap)
    q, k, v = cs.segmented_inputs(gen, plan.cap, 16, 80)
    times = {}
    for label, gid, starts, rng in (("full", plan.seg_id, plan.kv_starts, plan.kv_range),
                                    ("window", plan.win_id, plan.win_starts, plan.win_range)):
        g, st = cs.to_cuda(gid), cs.to_cuda(starts)
        times[f"K1 {label}"] = cs.cuda_ms(lambda: cs.flash.segmented_block_attention(q, k, v, g, st, rng), 20)
    print("K1_TIMES " + json.dumps({"card": cs.card(), "tree": str(Path(cs.flash.__file__).resolve().parents[2]),
                                    "ms": times, "config": cs.segmented_config(plan.cap, 16)}))


def run(tree: Path | None, log_dir: Path, k1: bool = False) -> dict:
    """chip_smoke.py --kernels (with k1, this script's --k1-times) on this
    tree (None) or a copy; its times."""
    cmd = [sys.executable, str(ROOT / ("kernel_variants.py" if k1 else "chip_smoke.py")),
           "--k1-times" if k1 else "--kernels"] + (["--tree", str(tree)] if tree else [])
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=900)
    name = tree.name if tree else "this_tree"
    (log_dir / f"{name}.log").write_text(out.stdout + out.stderr)
    tag = "K1_TIMES " if k1 else "KERNELS_AB "
    line = next((x for x in out.stdout.splitlines() if x.startswith(tag)), None)
    if out.returncode or line is None:
        sys.stdout.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"kernel_variants.py: the run of {name} failed ({out.returncode})")
    return json.loads(line[len(tag):])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clusters", default="1,2,3,4,6,8", help="CTAs a (slot, kv head) to time K3 and K3q with")
    ap.add_argument("--k1", action="store_true", help="time K1 against its load-only copies instead")
    ap.add_argument("--k1-times", action="store_true", help="(one process of --k1) time K1 on this tree or --tree")
    ap.add_argument("--tree", help="with --k1-times: the port of this directory")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants.py: no CUDA device; this script runs only on the GPU")
    if args.k1_times:
        k1_times()
        return
    log_dir = ROOT / "chiprun_out" / "kernel_variants"
    log_dir.mkdir(parents=True, exist_ok=True)
    if args.k1:
        trees = {name: copy_port(name, "flash_attn.cu", edits) for name, edits in K1_EDITS.items()}
    else:
        trees = {f"K3 clusters of {c}": make_variant(f"K3 clusters of {c}", "decode_attn.cu", DECODE_RULE,
                                                     f"return {c};")
                 for c in map(int, args.clusters.split(","))}
        trees.update({name: make_variant(name, "flash_attn.cu", CAUSAL_RULE, body)
                      for name, body in CAUSAL_VARIANTS.items()})
    times = {"this tree": run(None, log_dir, args.k1)["ms"]}
    card = None
    for name, tree in trees.items():
        res = run(tree, log_dir, args.k1)
        times[name], card = res["ms"], res["card"]
    times["this tree, again"] = run(None, log_dir, args.k1)["ms"]
    print("VARIANTS " + json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()
