"""Baseline config: one dataclass in place of the reference's Hydra yaml.

Counterpart of ``ctrlv_tpu/baseline/config.py``, with the same fields and
defaults plus ``device``, the device the two baseline commands run on: unset
means the card, ``device=cpu`` the CPU (as ``utils/config.py::Config``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    seed: int = 0
    max_steps: int = 70000
    lr_warmup_steps: int = 500
    train_batch_size: int = 2
    val_batch_size: int = 2
    lr: float = 5e-4
    weight_decay: float = 1e-4
    gradient_clip_val: float = 1.0
    dataset: str = "kitti"
    data_root: str = "./datasets"

    # conditioning
    condition_last_frame: bool = True
    initial_frames_condition_num: int = 3
    only_keep_initial_agents: bool = True
    always_predict_initial_agents: bool = False
    use_state_embeddings: bool = True
    map_embedding: bool = True
    last_frame_traj: bool = False

    # model
    state_dim: int = 4
    hidden_dim: int = 256
    dim_feedforward: int = 1024
    num_heads: int = 8
    num_decoder_layers: int = 4
    num_encoder_layers: int = 2
    dir_disc: int = 24
    norm_disc: int = 16
    existence_head: bool = False
    existence_loss_weight: float = 1.0
    coords_loss_weight: float = 1.0
    pred_coords: bool = False
    regression: bool = False
    smooth_gt_leaving_frame: bool = False

    num_timesteps: int = 25
    max_num_agents: int = 15
    video_fps: int = 7
    train_W: int = 512
    train_H: int = 320
    action_temp: float = 1.0

    device: Optional[str] = None  # None: the card; "cpu" for tests

    @property
    def vocabulary_size(self) -> int:
        # coords mode uses its own vocabulary (uniform [0,1] bins)
        return self.dir_disc * self.norm_disc

    @classmethod
    def tiny(cls, **kw) -> "BaselineConfig":
        defaults = dict(
            hidden_dim=32,
            dim_feedforward=64,
            num_heads=2,
            num_decoder_layers=2,
            num_encoder_layers=1,
            num_timesteps=5,
            max_num_agents=4,
            initial_frames_condition_num=2,
            map_embedding=False,
        )
        defaults.update(kw)
        return cls(**defaults)


def config_from_overrides(argv=None) -> BaselineConfig:
    """Hydra-style ``key=value`` overrides, the reference baseline's launch
    interface. The value's type comes from the field's annotation string,
    tested for "bool" before "int" as the JAX parser tests it; any other
    annotation (``str``, ``Optional[str]``) takes the string as it is."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    fields = {f.name: f for f in dataclasses.fields(BaselineConfig)}
    overrides = {}
    for arg in argv:
        key, sep, value = arg.partition("=")
        if not sep or key not in fields:
            raise SystemExit(
                f"unknown override {arg!r}; expected key=value with key in "
                f"{sorted(fields)}"
            )
        ann = str(fields[key].type)
        if "bool" in ann:
            overrides[key] = value.lower() in ("1", "true", "yes")
        elif "int" in ann:
            overrides[key] = int(value)
        elif "float" in ann:
            overrides[key] = float(value)
        else:
            overrides[key] = value
    return BaselineConfig(**overrides)
