"""Fractal (Google Robot) evaluation protocol grids: VM + VA.

Parity surface: src/agent/variant_aggressive_config.py —
`find_suitable_args_match` (visual matching, :455-861) and
`find_suitable_args` (variant aggregation, :10-454). The numbers below ARE
the benchmark protocol (env names, scenes, robot/object init grids, urdf
recolors, overlay images); they must match the reference exactly for the
VM/VA success columns of BASELINE.md to be comparable. The encoding is
restructured: one declarative VariantFamily schema + generators instead of
the reference's 1,000-line dict repetition.

Terminology: VM = sim-rendered scene visually matched to a real-robot photo
(rgb overlay + recolored urdf sweep); VA = aggressive environment variation
(backgrounds, lightings, textures, camera poses, distractors, stations).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..envs.geometry import euler2quat, quat2mat, mat2quat

TASKS = (
    "google_robot_pick_coke_can",
    "google_robot_move_near_v0",
    "google_robot_open_drawer",
    "google_robot_close_drawer",
    "google_robot_place_apple_in_closed_top_drawer",
)

# recolored-urdf sweep shared by every VM grid (:499-513 etc.)
VM_URDF_VERSIONS = (
    None,
    "recolor_tabletop_visual_matching_1",
    "recolor_tabletop_visual_matching_2",
    "recolor_cabinet_visual_matching_1",
)

# the three coke-can orientations (:124-128 and every coke-can family)
COKE_ORIENTATIONS = (
    {"lr_switch": True},
    {"upright": True},
    {"laid_vertically": True},
)

DRAWER_ENVS_OPEN_CLOSE = (
    "OpenTopDrawerCustomInScene-v0",
    "OpenMiddleDrawerCustomInScene-v0",
    "OpenBottomDrawerCustomInScene-v0",
    "CloseTopDrawerCustomInScene-v0",
    "CloseMiddleDrawerCustomInScene-v0",
    "CloseBottomDrawerCustomInScene-v0",
)

# the 9 visual-matching drawer stations: overlay photo + matched robot pose
# (x, y, yaw) (:506-779, A0..C2)
DRAWER_VM_STATIONS = (
    ("open_drawer_a0.png", 0.644, -0.179, -0.03),
    ("open_drawer_a1.png", 0.765, -0.182, -0.02),
    ("open_drawer_a2.png", 0.889, -0.203, -0.06),
    ("open_drawer_b0.png", 0.652, 0.009, 0.0),
    ("open_drawer_b1.png", 0.752, 0.009, 0.0),
    ("open_drawer_b2.png", 0.851, 0.035, 0.0),
    ("open_drawer_c0.png", 0.665, 0.224, 0.0),
    ("open_drawer_c1.png", 0.765, 0.222, -0.025),
    ("open_drawer_c2.png", 0.865, 0.222, -0.025),
)

# VM drawer/apple recolor kwargs (:513 region)
_VM_STATION_KW = {
    "station_name": "mk_station_recolor",
    "light_mode": "simple",
    "disable_bad_material": True,
}


@dataclass(frozen=True)
class VariantFamily:
    """One row of the reference's merged arg dicts, normalized."""

    env_names: Tuple[str, ...]
    scene_names: Tuple[str, ...]
    build_kwargs_variants: Tuple[Optional[Dict[str, Any]], ...] = (None,)
    robot_init_x: Tuple[float, float, int] = (0.35, 0.35, 1)
    robot_init_y: Tuple[float, float, int] = (0.20, 0.20, 1)
    rot_quat_center: Tuple[float, float, float, float] = (0, 0, 0, 1)
    # (r0, r1, nr, p0, p1, np, y0, y1, ny)
    rot_rpy_range: Tuple[float, ...] = (0, 0, 1, 0, 0, 1, 0, 0, 1)
    obj_variation_mode: str = "xy"  # 'xy' | 'episode'
    obj_init_x: Tuple[float, float, int] = (-0.35, -0.12, 5)
    obj_init_y: Tuple[float, float, int] = (-0.02, 0.42, 5)
    obj_episode_range: Tuple[int, int] = (0, 60)
    max_episode_steps: int = 80
    rgb_overlay: Optional[str] = None  # basename under real_inpainting/
    enable_raytracing: bool = False
    save_tags: Optional[str] = None


def parse_range(t: Sequence[float]) -> np.ndarray:
    """np.linspace over (lo, hi, n) (variant_aggressive_config.py:7-8)."""
    return np.linspace(t[0], t[1], int(t[2]))


def _quat_mul(a, b) -> np.ndarray:
    return mat2quat(quat2mat(np.asarray(a, float)) @ quat2mat(np.asarray(b, float)))


def robot_init_quats(family: VariantFamily) -> List[np.ndarray]:
    """rpy grid x quat-center -> concrete init quaternions (:886-891)."""
    rr = family.rot_rpy_range
    out = []
    for r in parse_range(rr[0:3]):
        for p in parse_range(rr[3:6]):
            for y in parse_range(rr[6:9]):
                out.append(_quat_mul(euler2quat(r, p, y), family.rot_quat_center))
    return out


def enumerate_env_specs(families: Sequence[VariantFamily]) -> Iterator[Dict[str, Any]]:
    """Concrete (env_name, scene_name, build_kwargs, init grids) specs —
    the unit the eval sweep iterates (one `get_env` + episode loop each)."""
    for fam in families:
        for env_name, scene, kw in itertools.product(
            fam.env_names, fam.scene_names, fam.build_kwargs_variants
        ):
            spec: Dict[str, Any] = {
                "env_name": env_name,
                "scene_name": scene,
                "build_kwargs": dict(kw) if kw else {},
                "max_episode_steps": fam.max_episode_steps,
                "robot_init_xs": parse_range(fam.robot_init_x).tolist(),
                "robot_init_ys": parse_range(fam.robot_init_y).tolist(),
                "robot_init_quats": [q.tolist() for q in robot_init_quats(fam)],
                "obj_variation_mode": fam.obj_variation_mode,
                "enable_raytracing": fam.enable_raytracing,
                "rgb_overlay": fam.rgb_overlay,
                "save_tags": fam.save_tags,
            }
            if fam.obj_variation_mode == "xy":
                spec["obj_init_xs"] = parse_range(fam.obj_init_x).tolist()
                spec["obj_init_ys"] = parse_range(fam.obj_init_y).tolist()
            else:
                spec["obj_episode_range"] = list(fam.obj_episode_range)
            yield spec


# --------------------------------------------------------------------------
# Variant aggregation (find_suitable_args, :10-454)
# --------------------------------------------------------------------------

def _coke_va() -> List[VariantFamily]:
    base = dict(
        env_names=("GraspSingleOpenedCokeCanInScene-v0",),
        scene_names=("google_pick_coke_can_1_v4",),
        build_kwargs_variants=COKE_ORIENTATIONS,
    )
    fams = [
        VariantFamily(**base),  # base scene
        VariantFamily(**{**base, "scene_names": (  # table textures
            "Baked_sc1_staging_objaverse_cabinet1_h870",
            "Baked_sc1_staging_objaverse_cabinet2_h870",
        )}),
        VariantFamily(**{**base,  # distractors: plain + 'more'
            "env_names": ("GraspSingleOpenedCokeCanDistractorInScene-v0",),
            "build_kwargs_variants": COKE_ORIENTATIONS + tuple(
                {**o, "distractor_config": "more"} for o in COKE_ORIENTATIONS
            ),
        }),
        VariantFamily(**{**base, "scene_names": (  # backgrounds
            "google_pick_coke_can_1_v4_alt_background",
            "google_pick_coke_can_1_v4_alt_background_2",
        )}),
        VariantFamily(**{**base, "build_kwargs_variants": tuple(  # darker
            {**o, "slightly_darker_lighting": True} for o in COKE_ORIENTATIONS
        )}),
        VariantFamily(**{**base, "build_kwargs_variants": tuple(  # brighter
            {**o, "slightly_brighter_lighting": True} for o in COKE_ORIENTATIONS
        )}),
        VariantFamily(**{**base, "env_names": (  # camera poses
            "GraspSingleOpenedCokeCanAltGoogleCameraInScene-v0",
            "GraspSingleOpenedCokeCanAltGoogleCamera2InScene-v0",
        )}),
    ]
    return fams


def _move_near_va() -> List[VariantFamily]:
    base = dict(
        env_names=("MoveNearGoogleInScene-v0",),
        scene_names=("google_pick_coke_can_1_v4",),
        robot_init_y=(0.21, 0.21, 1),
        rot_rpy_range=(0, 0, 1, 0, 0, 1, -0.09, -0.09, 1),
        obj_variation_mode="episode",
    )
    return [
        VariantFamily(**base),
        VariantFamily(**{**base, "build_kwargs_variants": ({"no_distractor": True},)}),
        VariantFamily(**{**base, "scene_names": (
            "google_pick_coke_can_1_v4_alt_background",
            "google_pick_coke_can_1_v4_alt_background_2",
        )}),
        VariantFamily(**{**base, "build_kwargs_variants": (
            {"slightly_darker_lighting": True},
            {"slightly_brighter_lighting": True},
        )}),
        VariantFamily(**{**base, "scene_names": (
            "Baked_sc1_staging_objaverse_cabinet1_h870",
            "Baked_sc1_staging_objaverse_cabinet2_h870",
        )}),
        VariantFamily(**{**base, "env_names": (
            "MoveNearAltGoogleCameraInScene-v0",
            "MoveNearAltGoogleCamera2InScene-v0",
        )}),
    ]


def _drawer_va() -> List[VariantFamily]:
    base = dict(
        env_names=DRAWER_ENVS_OPEN_CLOSE,
        scene_names=("frl_apartment_stage_simple",),
        max_episode_steps=113,
        robot_init_x=(0.65, 0.85, 3),
        robot_init_y=(-0.2, 0.2, 3),
        obj_init_x=(0.0, 0.0, 1),
        obj_init_y=(0.0, 0.0, 1),
    )
    return [
        VariantFamily(**base, enable_raytracing=True),
        VariantFamily(**{**base, "scene_names": (
            "modern_bedroom_no_roof", "modern_office_no_roof",
        ), "build_kwargs_variants": ({"shader_dir": "rt"},)}),
        VariantFamily(**{**base, "build_kwargs_variants": (
            {"shader_dir": "rt", "light_mode": "brighter"},
            {"shader_dir": "rt", "light_mode": "darker"},
        )}),
        VariantFamily(**{**base, "build_kwargs_variants": (
            {"shader_dir": "rt", "station_name": "mk_station2"},
            {"shader_dir": "rt", "station_name": "mk_station3"},
        )}),
    ]


def _apple_va() -> List[VariantFamily]:
    base = dict(
        env_names=("PlaceIntoClosedTopDrawerCustomInScene-v0",),
        scene_names=("frl_apartment_stage_simple",),
        max_episode_steps=200,
        robot_init_x=(0.65, 0.65, 1),
        robot_init_y=(-0.2, 0.2, 3),
        obj_init_x=(-0.08, -0.02, 3),
        obj_init_y=(-0.02, 0.08, 3),
    )
    return [
        VariantFamily(**base, enable_raytracing=True,
                      build_kwargs_variants=({"model_ids": "apple"},)),
        VariantFamily(**{**base, "scene_names": (
            "modern_bedroom_no_roof", "modern_office_no_roof",
        ), "build_kwargs_variants": (
            {"shader_dir": "rt", "model_ids": "apple"},
        )}),
        VariantFamily(**{**base, "build_kwargs_variants": (
            {"shader_dir": "rt", "light_mode": "brighter", "model_ids": "apple"},
            {"shader_dir": "rt", "light_mode": "darker", "model_ids": "apple"},
        )}),
        VariantFamily(**{**base, "build_kwargs_variants": (
            {"shader_dir": "rt", "station_name": "mk_station2", "model_ids": "apple"},
            {"shader_dir": "rt", "station_name": "mk_station3", "model_ids": "apple"},
        )}),
    ]


def variant_aggregation_families(task: str) -> List[VariantFamily]:
    """find_suitable_args(task) (:10-454)."""
    if task == "google_robot_pick_coke_can":
        return _coke_va()
    if task == "google_robot_move_near_v0":
        return _move_near_va()
    if task in ("google_robot_open_drawer", "google_robot_close_drawer"):
        return _drawer_va()
    if task == "google_robot_place_apple_in_closed_top_drawer":
        return _apple_va()
    raise KeyError(task)


# --------------------------------------------------------------------------
# Visual matching (find_suitable_args_match, :455-861)
# --------------------------------------------------------------------------

def visual_matching_families(task: str) -> List[VariantFamily]:
    if task == "google_robot_pick_coke_can":
        return [VariantFamily(
            env_names=("GraspSingleOpenedCokeCanInScene-v0",),
            scene_names=("google_pick_coke_can_1_v4",),
            rgb_overlay="google_coke_can_real_eval_1.png",
            build_kwargs_variants=tuple(
                {**o, "urdf_version": u}
                for u in VM_URDF_VERSIONS for o in COKE_ORIENTATIONS
            ),
        )]
    if task == "google_robot_move_near_v0":
        return [VariantFamily(
            env_names=("MoveNearGoogleBakedTexInScene-v0",),
            scene_names=("google_pick_coke_can_1_v4",),
            robot_init_y=(0.21, 0.21, 1),
            rot_rpy_range=(0, 0, 1, 0, 0, 1, -0.09, -0.09, 1),
            obj_variation_mode="episode",
            rgb_overlay="google_move_near_real_eval_1.png",
            # reference passes the literal string "None" here (:787) — kept
            # as None; the string is an upstream quirk with identical effect
            build_kwargs_variants=tuple(
                {"urdf_version": u} for u in VM_URDF_VERSIONS
            ),
            save_tags="baked_except_bpb_orange",
        )]
    if task in ("google_robot_open_drawer", "google_robot_close_drawer"):
        return [
            VariantFamily(
                env_names=DRAWER_ENVS_OPEN_CLOSE,
                scene_names=("dummy_drawer",),
                max_episode_steps=113,
                robot_init_x=(x, x, 1), robot_init_y=(y, y, 1),
                rot_rpy_range=(0, 0, 1, 0, 0, 1, yaw, yaw, 1),
                obj_init_x=(0.0, 0.0, 1), obj_init_y=(0.0, 0.0, 1),
                rgb_overlay=overlay,
                enable_raytracing=True,
                build_kwargs_variants=tuple(
                    {**_VM_STATION_KW, "urdf_version": u}
                    for u in (VM_URDF_VERSIONS[3], VM_URDF_VERSIONS[1],
                              VM_URDF_VERSIONS[2], VM_URDF_VERSIONS[0])
                ),
            )
            for overlay, x, y, yaw in DRAWER_VM_STATIONS
        ]
    if task == "google_robot_place_apple_in_closed_top_drawer":
        stations = [DRAWER_VM_STATIONS[0], DRAWER_VM_STATIONS[3],
                    DRAWER_VM_STATIONS[6]]  # A0, B0, C0 (:800-860)
        return [
            VariantFamily(
                env_names=(
                    "PlaceIntoClosedTopDrawerCustomInScene-v0",
                    "PlaceIntoClosedMiddleDrawerCustomInScene-v0",
                    "PlaceIntoClosedBottomDrawerCustomInScene-v0",
                ),
                scene_names=("dummy_drawer",),
                robot_init_x=(x, x, 1), robot_init_y=(y, y, 1),
                rot_rpy_range=(0, 0, 1, 0, 0, 1, yaw, yaw, 1),
                obj_init_x=(-0.08, -0.02, 3), obj_init_y=(-0.02, 0.08, 3),
                rgb_overlay=overlay,
                build_kwargs_variants=tuple(
                    {**_VM_STATION_KW, "urdf_version": u}
                    for u in (VM_URDF_VERSIONS[3], VM_URDF_VERSIONS[1],
                              VM_URDF_VERSIONS[2], VM_URDF_VERSIONS[0])
                ),
                save_tags="baked_apple_v2",
            )
            for overlay, x, y, yaw in stations
        ]
    raise KeyError(task)
