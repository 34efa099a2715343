"""Attack side of the port: sentence edits, the candidate scoring engine,
the text attacks (LEAF, Charmer, bruteforce) and the image attacks (PGD,
APGD, Square).  `attacks.apgd` is the module: its function of that name
is not exported here, where it would hide the module."""
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
from leaf_tpu_torch.attacks.apgd import (
    ce_loss_fn,
    dlr_targeted_loss_fn,
    l1_projection,
)
from leaf_tpu_torch.attacks.square import make_margin_loss_fn, square_attack

__all__ = [
    "DEFAULT_VOCAB", "apply_edit", "expand_slots", "generate_all_sentences",
    "generate_all_sentences_at_z", "generate_random_sentences",
    "generate_random_sentences_at_z", "num_slots", "WordConstraint",
    "CandidateScorer", "attack_text_leaf", "attack_text_bruteforce",
    "attack_text_charmer_inference", "attack_text_charmer_batched",
    "attack_text_charmer_constrained_ret",
    "attack_text_charmer_classification", "attack_image",
    "attack_image_classification", "pgd", "ce_loss_fn",
    "dlr_targeted_loss_fn", "l1_projection", "make_margin_loss_fn",
    "square_attack",
]
