"""The program's paint engine, built from a configuration file and the
benchmark's seeded weights (``neube_bench/weights.py``)."""

from __future__ import annotations

from typing import Dict


def program_configs(cfg: Dict):
    """(GeneratorConfig, GeoEncoderConfig) of the program for ``cfg``."""
    from brushstroke_engine_torch.models.generator import \
        make_generator_config
    from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
    from neube_bench import weights as W
    e = cfg["encoder"]
    enc = GeoEncoderConfig(
        kind=e["kind"], in_channels=e["in_channels"],
        out_channels=e["out_channels"], preproc=e["preproc"],
        pre_filters=e["pre_filters"], down_filters=tuple(e["down_filters"]),
        post_filters=tuple(e["post_filters"]),
        up_filters=tuple(e["up_filters"]))
    geom = W.geom_features(cfg)
    gen = make_generator_config(
        z_dim=cfg["z_dim"], w_dim=cfg["w_dim"],
        img_resolution=cfg["img_resolution"],
        geom_feature_resolutions=tuple(sorted(geom)),
        geom_feature_channels=tuple(geom[r] for r in sorted(geom)),
        color_format=cfg["color_format"],
        architecture=cfg["synthesis_arch"],
        channel_base=cfg["channel_base"], channel_max=cfg["channel_max"],
        num_bf16_res=cfg["num_bf16_res"], conv_clamp=cfg["conv_clamp"],
        mapping_layers=cfg["mapping_layers"])
    return gen, enc


def program_engine(cfg: Dict, trees: Dict, device):
    """A ``TriadGanPaintEngine`` over ``trees`` on ``device``, in the
    configuration's render mode."""
    from brushstroke_engine_torch.engine.brush import TriadGanPaintEngine
    gen, enc = program_configs(cfg)
    engine = TriadGanPaintEngine(
        gen, trees["gen_params"], trees["gen_state"], enc,
        trees["enc_params"], trees["enc_state"],
        geom_inject_resolutions=tuple(cfg["geom_inject_resolutions"]),
        device=device)
    engine.set_render_mode(cfg["render_mode"])
    return engine
