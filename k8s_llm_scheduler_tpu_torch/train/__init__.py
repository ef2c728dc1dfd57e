"""Training-side support of the port: the decision-quality report card
(eval.py) and the distillation corpus generator it draws from (distill.py,
`random_cases` only)."""
