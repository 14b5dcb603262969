"""nanort_tpu_torch.api"""
