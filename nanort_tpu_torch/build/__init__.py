"""nanort_tpu_torch.build"""
