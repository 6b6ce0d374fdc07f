"""RICES and RANDOM in-context example selection (the port's counterpart of
explicit_alignment_for_vqa_tasks_tpu/in_context_example_selection)."""

from .rices import (
    image_knn_from_text_knn,
    joint_ranking,
    question_knn,
    random_examples,
    run_full_pipeline,
)

__all__ = [
    "image_knn_from_text_knn",
    "joint_ranking",
    "question_knn",
    "random_examples",
    "run_full_pipeline",
]
