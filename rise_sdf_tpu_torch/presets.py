"""Config presets as plain dicts (the port reads no YAML).

``tiny_neus_config`` and ``tiny_split_config`` mirror their namesakes in
``rise_sdf_tpu/presets.py`` value for value.  The repo's two configs are
here whole: ``split_mixed_occ_tensoir`` is
``configs/split-mixed-occ-tensoir.yaml`` (the flagship on a TensoIR
scene) and ``neus_blender`` is ``configs/neus-blender.yaml`` (NeuS on a
scene in the Blender layout); like the yamls they leave
``dataset.scene`` to the command line (``dataset.scene=lego``), which
``launch.resolve`` requires and fills into ``name`` and
``dataset.root_dir``.  ``split_mixed_occ_full`` is the flagship's model
section.  The others train on the procedural ``synthetic-sphere`` at
800x800 in place of a download: ``neus_sphere_full`` (the model and
system of ``neus_blender``; ``neus_sphere_color_full`` the same with a
``volume-color`` head), ``split_mixed_occ_train_full`` (the whole
flagship config), ``split_mixed_occ_test_full`` (that plus the test
protocol on the sphere's test split, relighting under two analytic
environments) and its tiny counterpart ``tiny_split_test_config``.
``neus_colmap`` is NeuS on a real capture in COLMAP's layout (the
unbounded-scene members of instant-nsr-pl's ``configs/neus-colmap.yaml``
on ``neus_blender``'s foreground); ``dataset.root_dir`` is ``???`` and
``name`` ends in its base name.  ``tiny_neus_colmap_config`` is
``tiny_neus_config`` with a learned background (``TINY_BACKGROUND``).
"""

from __future__ import annotations

import os

# where the test presets' environment EXRs go (gitignored)
ENV_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache",
                       "envmaps")


def tiny_mlp(layers=1, neurons=16, sphere=False):
    cfg = {"otype": "VanillaMLP", "activation": "ReLU",
           "output_activation": "none", "n_neurons": neurons,
           "n_hidden_layers": layers}
    if sphere:
        cfg.update({"sphere_init": True, "sphere_init_radius": 0.5,
                    "weight_norm": True})
    return cfg


def geometry_cfg(grad_type="analytic", progressive=False, levels=4,
                 feature_dim=13, neurons=16):
    enc = {"otype": "ProgressiveBandHashGrid" if progressive else "HashGrid",
           "n_levels": levels, "n_features_per_level": 2,
           "log2_hashmap_size": 12, "base_resolution": 8,
           "per_level_scale": 1.6, "include_xyz": True}
    if progressive:
        enc.update({"start_level": 2, "start_step": 10, "update_steps": 10})
    g = {"name": "volume-sdf", "radius": 1.5, "feature_dim": feature_dim,
         "grad_type": grad_type,
         "isosurface": {"method": "mc", "resolution": 32, "chunk": 65536,
                        "threshold": 0.0},
         "xyz_encoding_config": enc,
         "mlp_network_config": tiny_mlp(1, neurons, sphere=True)}
    if grad_type == "finite_difference":
        g["finite_difference_eps"] = "progressive" if progressive else 0.01
    return g


def tiny_neus_config():
    return {
        "dataset": {"name": "synthetic-sphere", "img_wh": [32, 32],
                    "n_images": 3},
        "model": {
            "name": "neus", "radius": 1.5, "num_samples_per_ray": 64,
            "train_num_rays": 64, "max_train_num_rays": 64,
            "train_sample_capacity": 1024, "eval_samples_per_ray": 32,
            "grid_prune": True, "grid_prune_occ_thre": 0.001,
            "dynamic_ray_sampling": False, "randomized": True,
            "ray_chunk": 256, "cos_anneal_end": 20,
            "grid_resolution": 32,
            "learned_background": False, "background_color": "random",
            "variance": {"init_val": 0.3, "modulate": False},
            "geometry": geometry_cfg("analytic"),
            "texture": {
                "name": "volume-radiance", "input_feature_dim": 16,
                "dir_encoding_config": {"otype": "SphericalHarmonics",
                                        "degree": 4},
                "mlp_network_config": tiny_mlp(2, 16),
                "color_activation": "sigmoid"},
        },
        "system": {
            "name": "neus-system",
            "loss": {"lambda_rgb_mse": 10.0, "lambda_rgb_l1": 0.0,
                     "lambda_mask": 0.1, "lambda_eikonal": 0.1,
                     "lambda_sparsity": 0.01, "lambda_distortion": 0.0,
                     "lambda_opaque": 0.0, "sparsity_scale": 1.0},
            "optimizer": {"name": "Adam",
                          "args": {"lr": 0.01, "betas": [0.9, 0.99],
                                   "eps": 1e-15},
                          "params": {"geometry": {"lr": 0.01},
                                     "texture": {"lr": 0.01},
                                     "variance": {"lr": 0.001}}},
            "scheduler": {"name": "ExponentialLR",
                          "args": {"gamma": 0.999}},
        },
        "export": {"chunk_size": 65536, "export_vertex_color": True},
        "trainer": {"max_steps": 25, "log_every_n_steps": 10},
    }


def neus_sphere_full():
    """``configs/neus-blender.yaml`` with its interpolations resolved:
    texture ``input_feature_dim`` = feature_dim + 3 = 51, the warmup
    milestone 500, and the ExponentialLR gamma that the yaml resolver
    ``calc_exp_lr_decay_rate(0.1, max_steps - warmup)`` computes."""
    max_steps, warmup = 30000, 500
    return {
        "name": "neus-blender-synthetic-sphere",
        "seed": 42,
        "dataset": {"name": "synthetic-sphere", "img_wh": [800, 800],
                    "n_images": 16, "near_plane": 2.0, "far_plane": 6.0},
        "model": {
            "name": "neus", "radius": 1.5, "num_samples_per_ray": 1024,
            "train_num_rays": 4096, "max_train_num_rays": 4096,
            "train_sample_capacity": 1048576, "eval_samples_per_ray": 128,
            "grid_prune": True, "grid_prune_occ_thre": 0.001,
            "dynamic_ray_sampling": False, "batch_image_sampling": True,
            "randomized": True, "ray_chunk": 4096, "cos_anneal_end": 20000,
            "learned_background": False, "background_color": "random",
            "variance": {"init_val": 0.3, "modulate": False},
            "geometry": {
                "name": "volume-sdf", "radius": 1.5, "feature_dim": 48,
                "grad_type": "analytic",
                "isosurface": {"method": "mc", "resolution": 512,
                               "chunk": 2097152, "threshold": 0.0},
                "xyz_encoding_config": {
                    "otype": "HashGrid", "n_levels": 16,
                    "n_features_per_level": 2, "log2_hashmap_size": 19,
                    "base_resolution": 16,
                    "per_level_scale": 1.447269237440378,
                    "include_xyz": True},
                "mlp_network_config": {
                    "otype": "VanillaMLP", "activation": "ReLU",
                    "output_activation": "none", "n_neurons": 128,
                    "n_hidden_layers": 2, "sphere_init": True,
                    "sphere_init_radius": 0.5, "weight_norm": True},
            },
            "texture": {
                "name": "volume-radiance", "input_feature_dim": 48 + 3,
                "dir_encoding_config": {"otype": "SphericalHarmonics",
                                        "degree": 4},
                "mlp_network_config": {
                    "otype": "VanillaMLP", "activation": "ReLU",
                    "output_activation": "none", "n_neurons": 128,
                    "n_hidden_layers": 4},
                "color_activation": "sigmoid",
            },
        },
        "system": {
            "name": "neus-system",
            "loss": {"lambda_rgb_mse": 10.0, "lambda_rgb_l1": 0.0,
                     "lambda_mask": 0.1, "lambda_eikonal": 0.1,
                     "lambda_sparsity": 0.01, "lambda_distortion": 0.0,
                     "lambda_opaque": 0.0, "sparsity_scale": 1.0},
            "optimizer": {"name": "Adam",
                          "args": {"lr": 0.01, "betas": [0.9, 0.99],
                                   "eps": 1e-15},
                          "params": {"geometry": {"lr": 0.01},
                                     "texture": {"lr": 0.01},
                                     "variance": {"lr": 0.001}}},
            "warmup_steps": warmup,
            "scheduler": {
                "name": "SequentialLR", "interval": "step",
                "milestones": [warmup],
                "schedulers": [
                    {"name": "LinearLR",
                     "args": {"start_factor": 0.01, "end_factor": 1.0,
                              "total_iters": warmup}},
                    {"name": "ExponentialLR",
                     "args": {"gamma": 0.1 ** (1 / (max_steps - warmup))}},
                ]},
        },
        "export": {"chunk_size": 2097152, "export_vertex_color": True},
        "trainer": {"max_steps": max_steps, "log_every_n_steps": 100,
                    "val_check_interval": 10000},
    }


def neus_sphere_color_full():
    """``neus_sphere_full`` with a ``volume-color`` head: the geometry's
    48 features alone -> rgb, through the radiance head's MLP (4 hidden
    layers of 128, sigmoid)."""
    cfg = neus_sphere_full()
    radiance = cfg["model"]["texture"]
    cfg["name"] = "neus-color-synthetic-sphere"
    cfg["model"]["texture"] = {
        "name": "volume-color",
        "input_feature_dim": cfg["model"]["geometry"]["feature_dim"],
        "mlp_network_config": radiance["mlp_network_config"],
        "color_activation": radiance["color_activation"]}
    return cfg


def _merge(dst: dict, src: dict) -> dict:
    """Deep-merge ``src`` into ``dst`` (``src`` wins), as the JAX
    package's ``ConfigNode.merge``."""
    for k, v in src.items():
        if isinstance(dst.get(k), dict) and isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def tiny_split_config():
    tex_mlp = tiny_mlp(1, 16)
    cfg = tiny_neus_config()
    _merge(cfg["model"], {
        "name": "split-mixed-occ", "indirect_pred": True,
        "relighting_threshold": 0.3, "num_samples_per_secondary_ray": 16,
        "split_sum_kick_in_step": 10,
        "geometry": geometry_cfg("finite_difference", progressive=True),
        "texture": {
            "name": "volume-mixed-mip-split-occ", "input_feature_dim": 13,
            "other_dim": 3,
            "dir_encoding_config": {"otype": "SphericalHarmonics",
                                    "degree": 4},
            "xyz_encoding_config": {"otype": "VanillaFrequency",
                                    "n_frequencies": 3},
            "metallic_mlp_network_config": tex_mlp,
            "albedo_mlp_network_config": tex_mlp,
            "spec_mlp_network_config": tex_mlp,
            "roughness_mlp_network_config": tex_mlp,
            "secondary_mlp_network_config": tex_mlp,
            "color_activation": "sigmoid"},
        "light": {"name": "envlight-mip-cube",
                  "envlight_config": {"hdr_filepath": None, "clamp": True,
                                      "nmf_format": False, "scale": 0.5,
                                      "bias": 0.25, "base_res": 32}},
    })
    _merge(cfg["system"], {
        "name": "split-occ-system",
        "loss": {"lambda_rgb_phys_mse": 10.0, "lambda_rgb_phys_l1": 0.0,
                 "lambda_curvature": 0.5, "lambda_normal_orientation": 0.05,
                 "lambda_emitter_distillation": 0.0,
                 "lambda_eikonal": 0.05},
        "optimizer": {"params": {"emitter": {"lr": 0.01}}},
    })
    cfg["dataset"]["relight_list"] = []
    cfg["dataset"]["has_albedo"] = True
    cfg["dataset"]["has_roughness"] = True
    return cfg


def split_mixed_occ_full():
    """The flagship: ``configs/split-mixed-occ-tensoir.yaml``'s model
    section with its interpolations resolved (texture
    ``input_feature_dim`` = feature_dim + 0 = 48, ``prefilter_start_step``
    = ``split_sum_kick_in_step``), and the config's seed."""
    def head(layers):
        return {"otype": "VanillaMLP", "activation": "ReLU",
                "output_activation": "none", "n_neurons": 128,
                "n_hidden_layers": layers, "compute_dtype": "bfloat16"}

    return {
        "name": "split-mixed-occ-tensoir-bench",
        "seed": 42,
        "model": {
            "name": "split-mixed-occ", "indirect_pred": True,
            "relighting_threshold": 0.3, "radius": 1.5,
            "num_samples_per_ray": 1024, "num_samples_per_secondary_ray": 96,
            "derive_compaction": True,
            "secondary_sample_capacity_frac": 0.375,
            "eval_visibility_frac": 0.5, "visibility_prefilter": True,
            "prefilter_stride": 4, "prefilter_coarse_per_ray": 64,
            "prefilter_margin_intervals": 1.0, "prefilter_levels": 0,
            "eval_sdf_bake": "full", "eval_sdf_bake_cells": 128,
            "prefilter_start_step": 10000,
            "train_sample_capacity_prefiltered": 163840,
            "train_num_rays": 256, "max_train_num_rays": 4096,
            "eval_samples_per_ray": 64, "eval_banded_samples_per_ray": 8,
            "eval_band_reserve": 16384, "eval_ray_interleave": "golden",
            "eval_pipeline_depth": 2, "grid_prune": True,
            "grid_prune_occ_thre": 0.001, "dynamic_ray_sampling": True,
            "batch_image_sampling": True, "randomized": True,
            "ray_chunk": 4096, "cos_anneal_end": 10000,
            "learned_background": False, "split_sum_kick_in_step": 10000,
            "background_color": "random",
            "variance": {"init_val": 0.3, "modulate": False},
            "geometry": {
                "name": "volume-sdf", "radius": 1.5, "feature_dim": 48,
                "grad_type": "finite_difference",
                "finite_difference_eps": "progressive", "fd_fine_k": 3,
                "curvature_probe_frac": 0.25,
                "isosurface": {"method": "mc", "resolution": 512,
                               "chunk": 2097152, "threshold": 0.0},
                "xyz_encoding_config": {
                    "otype": "ProgressiveBandHashGrid", "n_levels": 16,
                    "start_level": 6, "start_step": 6000,
                    "update_steps": 500, "n_features_per_level": 2,
                    "log2_hashmap_size": 19, "base_resolution": 32,
                    "per_level_scale": 1.447269237440378,
                    "include_xyz": True},
                "mlp_network_config": {
                    "otype": "VanillaMLP", "activation": "ReLU",
                    "output_activation": "none", "n_neurons": 128,
                    "n_hidden_layers": 2, "sphere_init": True,
                    "sphere_init_radius": 0.5, "weight_norm": True,
                    "compute_dtype": "bfloat16"},
            },
            "texture": {
                "name": "volume-mixed-mip-split-occ",
                "input_feature_dim": 48, "other_dim": 3, "sample_size": 8,
                "dir_encoding_config": {"otype": "SphericalHarmonics",
                                        "degree": 5, "reflected": True},
                "metallic_mlp_network_config": head(2),
                "albedo_mlp_network_config": head(4),
                "spec_mlp_network_config": head(4),
                "roughness_mlp_network_config": head(2),
                "secondary_mlp_network_config": head(4),
                "xyz_encoding_config": {"otype": "VanillaFrequency",
                                        "n_frequencies": 6},
                "color_activation": "sigmoid",
            },
            "light": {"name": "envlight-mip-cube",
                      "envlight_config": {"hdr_filepath": None, "clamp": True,
                                          "nmf_format": False, "scale": 0.5,
                                          "bias": 0.25, "base_res": 512}},
        },
    }


def split_mixed_occ_tensoir():
    """``configs/split-mixed-occ-tensoir.yaml`` whole: its dataset section
    (TensoIR at 800x800), ``split_mixed_occ_full``'s model, and the
    system, checkpoint, export and trainer sections with the
    interpolations resolved (the warmup milestone 500 and the
    ExponentialLR gamma of ``calc_exp_lr_decay_rate(0.1, max_steps -
    warmup)``).  ``dataset.scene`` is ``???`` and ``name`` and
    ``dataset.root_dir`` hold ``${dataset.scene}``, as in the yaml: the
    launcher raises until the scene is set and then fills both in
    (``launch.resolve``)."""
    max_steps, warmup = 80000, 500
    return {
        "name": "split-mixed-occ-tensoir-${dataset.scene}",
        "tag": "",
        "seed": 42,
        "dataset": {
            "name": "tensoir", "scene": "???",
            "root_dir": "./load/TensoIR_Synthetic/${dataset.scene}",
            "img_wh": [800, 800], "near_plane": 2.0, "far_plane": 6.0,
            "train_split": "train", "val_split": "test",
            "test_split": "test", "openGL_camera": True,
            "hdr_input": False, "relight_list": [],
            "hdr_filepath": "./load/high_res_envmaps_2k/",
            "has_albedo": True, "albedo_format": "exr",
            "has_roughness": True, "roughness_format": "exr"},
        "model": split_mixed_occ_full()["model"],
        "system": {
            "name": "split-occ-system",
            "loss": {"lambda_rgb_mse": 10.0, "lambda_rgb_l1": 0.0,
                     "lambda_rgb_phys_mse": 10.0, "lambda_rgb_phys_l1": 0.0,
                     "lambda_mask": 0.1, "lambda_eikonal": 0.05,
                     "lambda_sparsity": 0.01, "lambda_curvature": 1,
                     "lambda_distortion": 0.0, "lambda_opaque": 0.0,
                     "lambda_normal_orientation": 0.05,
                     "lambda_emitter_distillation": 0.0,
                     "sparsity_scale": 1.0},
            "optimizer": {"name": "Adam",
                          "args": {"lr": 0.005, "betas": [0.9, 0.999],
                                   "eps": 1e-12},
                          "params": {"geometry": {"lr": 0.005},
                                     "texture": {"lr": 0.005},
                                     "variance": {"lr": 0.001},
                                     "emitter": {"lr": 0.01}}},
            "warmup_steps": warmup,
            "scheduler": {
                "name": "SequentialLR", "interval": "step",
                "milestones": [warmup],
                "schedulers": [
                    {"name": "LinearLR",
                     "args": {"start_factor": 0.01, "end_factor": 1.0,
                              "total_iters": warmup}},
                    {"name": "ExponentialLR",
                     "args": {"gamma": 0.1 ** (1 / (max_steps - warmup))}},
                ]},
        },
        "checkpoint": {"save_top_k": -1, "every_n_train_steps": max_steps},
        "export": {"chunk_size": 2097152, "export_vertex_color": True},
        "trainer": {"max_steps": max_steps, "log_every_n_steps": 100,
                    "num_sanity_val_steps": 0, "val_check_interval": 5000,
                    "limit_train_batches": 1.0, "limit_val_batches": 3,
                    "enable_progress_bar": True, "precision": 32},
    }


def split_mixed_occ_train_full():
    """``split_mixed_occ_tensoir`` trained on the procedural
    ``synthetic-sphere`` at the config's own 800x800 in place of a
    TensoIR scene (a download)."""
    scene = "synthetic-sphere"
    cfg = split_mixed_occ_tensoir()
    cfg["name"] = f"split-mixed-occ-tensoir-{scene}"
    cfg["dataset"] = {"name": scene, "img_wh": [800, 800], "n_images": 16,
                      "near_plane": 2.0, "far_plane": 6.0,
                      "relight_list": []}
    return cfg


def neus_blender():
    """``configs/neus-blender.yaml`` whole: its dataset section (Blender
    layout at 800x800), ``neus_sphere_full``'s model, system and export,
    and the checkpoint and trainer sections.  ``dataset.scene`` is
    ``???`` and ``name`` and ``dataset.root_dir`` hold
    ``${dataset.scene}`` (``split_mixed_occ_tensoir``)."""
    full = neus_sphere_full()
    max_steps = full["trainer"]["max_steps"]
    return {
        "name": "neus-blender-${dataset.scene}",
        "tag": "",
        "seed": 42,
        "dataset": {
            "name": "blender", "scene": "???",
            "root_dir": "./load/TensoIR_Synthetic/${dataset.scene}",
            "img_wh": [800, 800], "near_plane": 2.0, "far_plane": 6.0,
            "train_split": "train", "val_split": "test",
            "test_split": "test", "openGL_camera": True,
            "hdr_input": False},
        "model": full["model"],
        "system": full["system"],
        "checkpoint": {"save_top_k": -1, "every_n_train_steps": max_steps},
        "export": full["export"],
        "trainer": {"max_steps": max_steps, "log_every_n_steps": 100,
                    "num_sanity_val_steps": 2, "val_check_interval": 10000,
                    "limit_train_batches": 1.0, "limit_val_batches": 5,
                    "enable_progress_bar": True, "precision": 32},
    }


def _test_protocol(cfg, hdr_filepath, n_images):
    """``cfg`` with the flagship yaml's test protocol on the synthetic
    sphere: albedo and roughness ground truth, relighting under the
    analytic ``warm`` and ``bright`` environments (written as EXRs under
    ``hdr_filepath``), ``n_images`` test views."""
    cfg["dataset"].update({
        "relight_list": ["warm", "bright"], "hdr_filepath": hdr_filepath,
        "n_images": n_images, "has_albedo": True, "has_roughness": True})
    return cfg


def split_mixed_occ_test_full(hdr_filepath: str = ENV_DIR):
    """``split_mixed_occ_train_full`` with the flagship's test protocol at
    800x800 (``derive_compaction`` on, as the model section sets it).
    Cut in depth: 4 test views where the reference protocol renders
    TensoIR's 200."""
    return _test_protocol(split_mixed_occ_train_full(), hdr_filepath, 4)


def tiny_split_test_config(hdr_filepath: str = ENV_DIR):
    """``tiny_split_config`` with the test protocol (2 views at 32x32)
    and ``derive_compaction`` on."""
    cfg = _test_protocol(tiny_split_config(), hdr_filepath, 2)
    cfg["model"]["derive_compaction"] = True
    return cfg


def background(radius, levels, log2_size, base_res, scale, neurons):
    """The ``model`` members of a learned background: a ``volume-density``
    field (8 features, ``trunc_exp`` density with bias -1, a hash grid
    and a one-hidden-layer ReLU MLP) and a ``volume-radiance`` head on
    its features (SH degree 4, two hidden layers, sigmoid)."""
    mlp = {"otype": "VanillaMLP", "activation": "ReLU",
           "output_activation": "none", "n_neurons": neurons}
    return {
        "geometry_bg": {
            "name": "volume-density", "radius": radius, "feature_dim": 8,
            "density_activation": "trunc_exp", "density_bias": -1,
            "isosurface": None,
            "xyz_encoding_config": {
                "otype": "HashGrid", "n_levels": levels,
                "n_features_per_level": 2, "log2_hashmap_size": log2_size,
                "base_resolution": base_res, "per_level_scale": scale},
            "mlp_network_config": dict(mlp, n_hidden_layers=1)},
        "texture_bg": {
            "name": "volume-radiance", "input_feature_dim": 8,
            "dir_encoding_config": {"otype": "SphericalHarmonics",
                                    "degree": 4},
            "mlp_network_config": dict(mlp, n_hidden_layers=2),
            "color_activation": "sigmoid"},
    }


# the tiny background: the tiny geometry's grid widths, 16 samples per ray
TINY_BACKGROUND = dict(background(1.5, 4, 12, 8, 1.6, 16),
                       learned_background=True, num_samples_per_ray_bg=16)
BACKGROUND_LR = {"geometry_bg": {"lr": 0.01}, "texture_bg": {"lr": 0.01}}


def tiny_neus_colmap_config():
    """``tiny_neus_config`` with ``TINY_BACKGROUND`` merged into its model
    and the background's optimizer groups at lr 0.01."""
    cfg = tiny_neus_config()
    cfg["model"].update(TINY_BACKGROUND)
    cfg["system"]["optimizer"]["params"].update(BACKGROUND_LR)
    return cfg


def neus_colmap():
    """NeuS on an unbounded real capture in COLMAP's layout (PNG images).
    The foreground is ``neus_blender``'s at radius 0.5 (normalised poses
    put the nearest camera at distance 1); the background, its 256
    samples per ray, its lr 0.01 groups, ``lambda_mask`` 0,
    ``lambda_distortion`` 0, 20,000 steps and the dataset section are
    instant-nsr-pl's ``configs/neus-colmap.yaml``.  ``dataset.root_dir``
    is ``???``: the launcher raises until it is set and names the run
    after its base name (``${basename:...}``)."""
    max_steps, warmup = 20000, 500
    cfg = neus_blender()
    model = cfg["model"]
    model.update({"radius": 0.5, "learned_background": True,
                  "num_samples_per_ray_bg": 256})
    model["geometry"] = dict(model["geometry"], radius=0.5)
    model.update(background(0.5, 16, 19, 32, 1.3195079107728942, 64))
    system = cfg["system"]
    system["loss"].update({"lambda_mask": 0.0, "lambda_distortion": 0.0})
    system["optimizer"]["params"].update(BACKGROUND_LR)
    system["scheduler"]["schedulers"][1]["args"]["gamma"] = \
        0.1 ** (1 / (max_steps - warmup))
    cfg.update({
        "name": "neus-colmap-${basename:dataset.root_dir}",
        "dataset": {"name": "colmap", "root_dir": "???",
                    "img_downscale": 4, "up_est_method": "ground",
                    "center_est_method": "lookat", "n_test_traj_steps": 120,
                    "apply_mask": False},
        "checkpoint": {"save_top_k": -1, "every_n_train_steps": max_steps}})
    cfg["trainer"]["max_steps"] = max_steps
    return cfg
