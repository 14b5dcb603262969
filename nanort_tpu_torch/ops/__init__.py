"""nanort_tpu_torch.ops"""
