"""The eval path: the eval CLI and logits export (``eval.evaluate``, run as
``python -m afft_tpu_torch.eval``) and the marginalization, late fusion and
challenge packaging (``eval.challenge``)."""
