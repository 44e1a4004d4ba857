"""Segment Anything in PyTorch: the model (modeling.py), official weights
(weights.py), the predictor (predictor.py) and the automatic mask
generator (amg.py)."""
