"""Score LongBench predictions (reference eval/LongBench/eval.py).

    python -m omniserve_tpu_torch.eval.longbench.eval --pred-dir pred
"""

import argparse
import glob
import json
import os
from typing import Dict, Optional, Sequence

from omniserve_tpu_torch.eval.longbench.metrics import DATASET2METRIC


def score_file(path: str) -> float:
    name = os.path.splitext(os.path.basename(path))[0]
    metric = DATASET2METRIC[name]
    total, n = 0.0, 0
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            best = 0.0
            for gt in r["answers"]:
                best = max(
                    best,
                    metric(r["pred"], gt, all_classes=r.get("all_classes")),
                )
            total += best
            n += 1
    return 100.0 * total / max(n, 1)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    p = argparse.ArgumentParser()
    p.add_argument("--pred-dir", default="pred")
    args = p.parse_args(argv)
    scores = {}
    for path in sorted(glob.glob(os.path.join(args.pred_dir, "*.jsonl"))):
        name = os.path.splitext(os.path.basename(path))[0]
        if name in DATASET2METRIC:
            scores[name] = round(score_file(path), 2)
    print(json.dumps(scores, indent=2))
    if scores:
        print(f"macro average: {sum(scores.values()) / len(scores):.2f}")
    return scores


if __name__ == "__main__":
    main()
