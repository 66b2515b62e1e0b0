"""The training loop: loss, gradients through `torch.autograd`, AdamW."""
