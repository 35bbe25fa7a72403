"""Evaluation: InceptionV3 features, FID, IS, KID, PRDC and the pre-calculate / calc evaluation."""
