"""A CPU-sized configuration and traffic mix with the layout of the real
ones, for the tests: the harness runs them end to end on the CPU, where the
program takes its plain kernel versions."""

import copy
import json
import os
import shutil

TINY_CONFIG = {
    "name": "tiny",
    "source": "https://huggingface.co/runwayml/stable-diffusion-v1-5",
    "unet": {"attention_head_dim": 2, "block_out_channels": [32, 64],
             "cross_attention_dim": 32, "in_channels": 4, "out_channels": 4,
             "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
             "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "layers_per_block": 1},
    "vae": {"block_out_channels": [16, 32], "in_channels": 3, "out_channels": 3,
            "latent_channels": 4, "layers_per_block": 1, "scaling_factor": 0.18215},
    "scheduler": {"beta_end": 0.012, "beta_schedule": "scaled_linear", "beta_start": 0.00085,
                  "num_train_timesteps": 1000, "prediction_type": "epsilon",
                  "set_alpha_to_one": False, "steps_offset": 1},
    "text": {"context_length": 8, "context_width": 32},
    "guide": {"arch": "tiny_resnet", "stage_sizes": [1, 1], "base_width": 8, "num_classes": 4,
              "input_size": 32},
    "sample_size": 32,
    "dtype": "float32",
    "assumed": [],
}

TINY_XL = copy.deepcopy(TINY_CONFIG)
TINY_XL["name"] = "tiny_xl"
TINY_XL["unet"].update({"addition_embed_type": "text_time", "attention_head_dim": [2, 2, 4],
                        "block_out_channels": [16, 32, 64],
                        "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                                             "CrossAttnDownBlock2D"],
                        "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                                           "UpBlock2D"],
                        "projection_class_embeddings_input_dim": 16 + 6 * 8,
                        "transformer_layers_per_block": [1, 1, 2],
                        "use_linear_projection": True, "cross_attention_dim": 48})
TINY_XL["text"] = {"context_length": 8, "context_width": 48, "pooled_width": 16,
                   "time_ids": [32, 32, 0, 0, 32, 32]}

TINY_TRAFFIC = {
    "batch": 2, "classes": 4, "items_per_class": 1, "images_per_prompt": 2,
    "writer_threads": 2, "steps": 10, "scheduler": "ddim", "strength": 0.5,
    "guidance_scale": 7.5,
    "guidance": {"type": "transform_guidance", "step": 4, "period": 2, "K": 3, "rho": 10.0,
                 "constraint_value": 0.2, "gs": 1.0, "ls": 1.0},
    "warmup_batches": 1, "profile_batches": 1,
}


def make_tree(root: str, configs=(TINY_CONFIG,), traffic=None, limits=None) -> str:
    """A checkout-like tree under ``root``: BENCHMARK.json naming one cell per
    (configuration, traffic) given, the portbench files, and the tiny data."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(src, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(os.path.dirname(src), "BENCHMARK.json")) as f:
        bench = json.load(f)
    traffic = traffic or {"tiny_guided": TINY_TRAFFIC}
    bench["configs"], bench["workloads"] = [], []
    for cfg in configs:
        path = f"portbench/configs/{cfg['name']}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": cfg["name"], "source": cfg["source"], "file": path,
                                 "reduced": [], "why": "tests"})
        for tname, t in traffic.items():
            with open(os.path.join(root, "portbench", "traffic", f"{tname}.json"), "w") as f:
                json.dump(t, f)
            cell = f"{cfg['name']}_{tname}"
            bench["workloads"].append({"name": cell, "config": cfg["name"], "traffic": tname,
                                       "chips": 1, "why": "tests"})
            if limits is not None:
                with open(os.path.join(root, "portbench", "limits", f"{cell}.json"), "w") as f:
                    json.dump(limits, f)
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
