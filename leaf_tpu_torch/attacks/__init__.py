"""Attack side of the port: sentence edits, the candidate scoring engine,
the text attacks (LEAF, Charmer, bruteforce) and the image attacks."""
from leaf_tpu_torch.attacks.edits import (
    DEFAULT_VOCAB,
    apply_edit,
    expand_slots,
    generate_all_sentences,
    generate_all_sentences_at_z,
    generate_random_sentences,
    generate_random_sentences_at_z,
    num_slots,
)
from leaf_tpu_torch.attacks.constraint import WordConstraint
from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.attacks.text import (
    attack_text_bruteforce,
    attack_text_charmer_batched,
    attack_text_charmer_classification,
    attack_text_charmer_constrained_ret,
    attack_text_charmer_inference,
    attack_text_leaf,
)
from leaf_tpu_torch.attacks.image import (
    attack_image,
    attack_image_classification,
    pgd,
)

__all__ = [
    "DEFAULT_VOCAB", "apply_edit", "expand_slots", "generate_all_sentences",
    "generate_all_sentences_at_z", "generate_random_sentences",
    "generate_random_sentences_at_z", "num_slots", "WordConstraint",
    "CandidateScorer", "attack_text_leaf", "attack_text_bruteforce",
    "attack_text_charmer_inference", "attack_text_charmer_batched",
    "attack_text_charmer_constrained_ret",
    "attack_text_charmer_classification", "attack_image",
    "attack_image_classification", "pgd",
]
