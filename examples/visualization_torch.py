"""Attention-pattern visualization on the PyTorch/CUDA port
(``kvcache_factory_tpu_torch``), the counterpart of
``examples/visualization.py``: per-layer attention heatmaps and the
per-layer / per-head KV budget allocation of a compressed prefill.

Run: python examples/visualization_torch.py [--model_path HF_DIR] [--out_dir viz_out]
     [--device cuda|cpu]
Without --model_path a small randomly initialized model is used.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--out_dir", default="viz_out")
    ap.add_argument("--prompt_len", type=int, default=256)
    ap.add_argument("--method", default="snapkv")
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (kernels run their plain versions)")
    args = ap.parse_args(argv)

    import torch
    from kvcache_factory_tpu_torch.config import CompressionConfig, ModelConfig
    from kvcache_factory_tpu_torch.models import llama
    from kvcache_factory_tpu_torch.models.weights import init_params, load_params
    from kvcache_factory_tpu_torch.utils import (infer_attention, plot_attention_heatmap,
                                                 plot_budget_allocation)

    if args.model_path:
        params, cfg = load_params(args.model_path, device=args.device)
    else:
        cfg = ModelConfig(model_type="llama", vocab_size=256, hidden_size=128,
                          intermediate_size=256, num_hidden_layers=4,
                          num_attention_heads=8, num_key_value_heads=4,
                          head_dim=16, dtype="float32")
        params = init_params(cfg, seed=0, device=args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=args.prompt_len)

    maps = infer_attention(params, cfg, toks)
    written = []
    for li in (0, len(maps) // 2, len(maps) - 1):
        p = plot_attention_heatmap(
            maps[li], save_path=os.path.join(args.out_dir, f"attn_layer{li}.png"),
            title=f"layer {li} (mean heads)")
        print("wrote", p)
        written.append(p)

    comp = CompressionConfig(method=args.method, max_capacity_prompt=args.capacity,
                             window_size=8, kernel_size=7, pooling="maxpool")
    dev = params["embed"].device
    with torch.no_grad():
        res = llama.prefill(params, cfg, comp,
                            torch.as_tensor(toks[None], dtype=torch.int64, device=dev),
                            torch.tensor([len(toks)], dtype=torch.int32, device=dev),
                            cache_capacity=comp.layer_capacity(cfg.num_hidden_layers,
                                                               len(toks)))
    p = plot_budget_allocation(res.cache.lengths,
                               save_path=os.path.join(args.out_dir, "budgets.png"))
    print("wrote", p)
    written.append(p)
    return written


if __name__ == "__main__":
    main()
