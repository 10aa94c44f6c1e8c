"""Needle results -> depth x length heatmap (the port's own copy of
``kvcache_factory_tpu/evals/needle_viz.py``; the plotting packages are
imported only by :func:`plot_heatmap`).

Behavioral match to scripts/scripts_needle/visualize.py: per-cell rescoring by
word overlap between the model response and the needle's answer phrase
(:43-46), pivot to (Document Depth x Context Length), heatmap with the
red->yellow->green colormap and a vertical line at the pretrained context
limit (:69-99).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

EXPECTED_ANSWER = "eat a sandwich and sit in Dolores Park on a sunny day."


def load_scores(results_folder: str,
                expected_answer: str = EXPECTED_ANSWER) -> List[dict]:
    data = []
    for path in glob.glob(os.path.join(results_folder, "*.json")):
        with open(path) as f:
            d = json.load(f)
        response = (d.get("model_response") or "").lower()
        expected = set(expected_answer.lower().split())
        score = len(set(response.split()) & expected) / len(expected)
        data.append({
            "Document Depth": d.get("depth_percent"),
            "Context Length": d.get("context_length"),
            "Score": score,
        })
    return data


def overall_score(results_folder: str) -> float:
    rows = load_scores(results_folder)
    if not rows:
        return 0.0
    return sum(r["Score"] for r in rows) / len(rows)


def plot_heatmap(results_folder: str, save_path: str, model_name: str = "model",
                 pretrained_len: Optional[int] = None) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns
    from matplotlib.colors import LinearSegmentedColormap

    df = pd.DataFrame(load_scores(results_folder))
    pivot = pd.pivot_table(df, values="Score",
                           index=["Document Depth", "Context Length"],
                           aggfunc="mean").reset_index()
    pivot = pivot.pivot(index="Document Depth", columns="Context Length",
                        values="Score")

    cmap = LinearSegmentedColormap.from_list(
        "custom_cmap", ["#F0496E", "#EBB839", "#0CD79F"])
    plt.figure(figsize=(min(38, 2 + pivot.shape[1]), 8))
    sns.heatmap(pivot, vmin=0, vmax=1, cmap=cmap,
                cbar_kws={"label": "Score"}, linewidths=0.5, linecolor="grey")
    plt.title(f'Pressure Testing {model_name}\nFact Retrieval Across Context '
              f'Lengths ("Needle In A HayStack")', fontsize=18)
    plt.xlabel("Token Limit", fontsize=18)
    plt.ylabel("Depth Percent", fontsize=18)
    plt.xticks(rotation=45)
    plt.tight_layout()
    if pretrained_len is not None:
        cols = sorted(df["Context Length"].unique())
        li = next((i for i, c in enumerate(cols) if c > pretrained_len),
                  len(cols))
        plt.axvline(x=li + 0.8, color="white", linestyle="--", linewidth=4)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=150)
    plt.close()
    return save_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results_folder", type=str, required=True)
    ap.add_argument("--save_path", type=str, required=True)
    ap.add_argument("--model_name", type=str, default="model")
    ap.add_argument("--pretrained_len", type=int, default=None)
    args = ap.parse_args(argv)
    print("Overall score %.3f" % overall_score(args.results_folder))
    plot_heatmap(args.results_folder, args.save_path, args.model_name,
                 args.pretrained_len)


if __name__ == "__main__":
    main()
