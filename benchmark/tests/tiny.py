"""Tiny cells for the CPU tests: the repo's configs/tiny_test.yaml and
configs/tiny_latent_test.yaml sizes, the production traffic's sampler at 4
chains, run on the CPU through the port's plain versions."""
import copy
import json
import os

import cells

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

PIXEL_MODEL = {"image_size": 16, "num_channels": 32, "num_res_blocks": 1, "channel_mult": "1,2",
               "learn_sigma": True, "class_cond": False, "attention_resolutions": 8,
               "num_heads": 2, "num_head_channels": 16, "num_heads_upsample": -1,
               "use_scale_shift_norm": True, "dropout": 0.0, "resblock_updown": True}
LATENT_MODEL = {"linear_start": 0.0015, "linear_end": 0.0195, "timesteps": 100, "image_size": 8,
                "channels": 3,
                "unet": {"image_size": 8, "in_channels": 3, "out_channels": 3,
                         "model_channels": 32, "attention_resolutions": [2],
                         "num_res_blocks": 1, "channel_mult": [1, 2], "num_head_channels": 16},
                "first_stage": {"embed_dim": 3, "n_embed": 32, "ch": 32, "ch_mult": [1, 2],
                                "num_res_blocks": 1, "z_channels": 3, "resolution": 16}}


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def cell(kind: str, chains: int = 4, limits=None, attempts=(0, 2)) -> cells.Cell:
    """A tiny pixel ('ffhq_adm') or latent ('ffhq_ldm') cell in float32,
    held to the full-size cell's limits unless `limits` is given."""
    name, traffic = {"ffhq_adm": ("ffhq_adm.hmc8_inpaint", "hmc8_inpaint"),
                     "ffhq_ldm": ("ffhq_ldm.hmc8_inpaint_f32", "hmc8_inpaint_f32")}[kind]
    config = _json("configs", f"{kind}.json")
    config = copy.deepcopy(config)
    config["dtype"] = "float32"
    config["data"] = {"image_size": 16, "channels": 3}
    if kind == "ffhq_adm":
        config["model"] = dict(PIXEL_MODEL)
    else:
        config["model"] = copy.deepcopy(LATENT_MODEL)
    tr = dict(_json("traffic", f"{traffic}.json"), chains=chains)
    workload = {"config": kind, "traffic": traffic, "chips": 1, "why": "tiny",
                "check": {"attempts": list(attempts), "chains": chains, "chunk": 2},
                "limits": limits if limits is not None else
                _json("workloads", f"{name}.json")["limits"]}
    bench = _json("..", "BENCHMARK.json")
    entry = {"name": name, "config": kind, "traffic": traffic, "chips": 1}
    return cells.Cell(name=name, entry=entry, workload=workload, traffic=tr, config=config,
                      end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])
