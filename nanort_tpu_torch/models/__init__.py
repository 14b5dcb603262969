"""nanort_tpu_torch.models"""
