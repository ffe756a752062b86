"""Training examples of the PyTorch package, run as modules, e.g.
``python -m cudaneuralrender_torch.examples.train_sdf`` (``--device cpu``
for a run without a card)."""
