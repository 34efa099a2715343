"""The benchmark suite of the port (no eager imports): so far the
AutoAttack-style APGD cascade of zero-shot classification, which the
ImageNet robust eval runs (ROADMAP Queue 1 item 12 has the rest)."""
