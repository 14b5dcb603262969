"""nanort_tpu_torch.io"""
