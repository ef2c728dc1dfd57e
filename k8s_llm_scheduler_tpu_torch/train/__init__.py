"""Training on one device: the causal-LM train step (train_step.py), the
self-distillation corpus and `train_and_save` (distill.py), the
hidden-transfer head for the draft-free speculative arm (hidden.py), and
the decision-quality report card (eval.py)."""
