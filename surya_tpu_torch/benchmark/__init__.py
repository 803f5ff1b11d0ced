"""The port's accuracy stages (counterpart of the repo's ``benchmark/``,
the Surya half of each stage): detection, recognition, layout, reading
order, table recognition and texify, each with the JAX stage's inputs,
metrics and result file; ``scripts/validate_checkpoints.py`` drives them
and applies the score gates."""
