from .optimizer import TrainResult, train_pose_mlp, transform_by_labels
from .pipeline import (
    RegistrationConfig,
    SequenceResult,
    predicted_world_points,
    register_sequence,
    register_sequences_batched,
    register_sequences_fused,
)
from .segments import SegmentInit, initial_segments, local_points_from_labels

__all__ = [
    "train_pose_mlp",
    "TrainResult",
    "transform_by_labels",
    "RegistrationConfig",
    "SequenceResult",
    "register_sequence",
    "register_sequences_batched",
    "register_sequences_fused",
    "predicted_world_points",
    "initial_segments",
    "local_points_from_labels",
    "SegmentInit",
]
