"""nanort_tpu_torch.core"""
