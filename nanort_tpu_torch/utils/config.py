"""JSON render configuration (the reference's picojson RenderConfig; a
copy of ``nanort_tpu.utils.config`` whose ``camera`` builds the port's
``models.cameras.Camera`` on ``device``).

Every reference example reads a ``config.json`` into a RenderConfig struct
(gui/render-config.cc:11-30, uv_raster/main.cc:215-224 show the typed
field extraction). Same fields, stdlib json.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class RenderConfig:
    """Reference gui/render-config.h fields (plus camera type selection by
    name against the registry, gui/camera.h:174-208)."""

    # image
    width: int = 512
    height: int = 512
    max_passes: int = 128
    # scene
    obj_filename: str = ""
    scene_scale: float = 1.0
    # camera
    camera_type: str = "perspective"
    eye: tuple = (0.0, 0.0, 5.0)
    look_at: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov: float = 45.0
    # AOV toggles (gui/render-config.h:34-41)
    pass_normal: bool = True
    pass_position: bool = True
    pass_depth: bool = True
    pass_texcoord: bool = True
    pass_prim_id: bool = True

    @classmethod
    def load(cls, path: str) -> "RenderConfig":
        with open(path) as f:
            raw = json.load(f)
        cfg = cls()
        for k, v in raw.items():
            if hasattr(cfg, k):
                cur = getattr(cfg, k)
                if isinstance(cur, tuple):
                    v = tuple(float(x) for x in v)
                elif isinstance(cur, bool):
                    v = bool(v)
                elif isinstance(cur, int):
                    v = int(v)
                elif isinstance(cur, float):
                    v = float(v)
                setattr(cfg, k, v)
        return cfg

    def save(self, path: str) -> None:
        d = dataclasses.asdict(self)
        d = {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}
        with open(path, "w") as f:
            json.dump(d, f, indent=2)

    def camera(self, device="cuda"):
        """The configured pinhole camera, its basis on ``device`` (the
        card unless the caller asks for another device)."""
        from ..models.cameras import look_at as _look_at

        return _look_at(
            eye=self.eye,
            center=self.look_at,
            up=self.up,
            width=self.width,
            height=self.height,
            fov=self.fov,
            device=device,
        )
