"""nanort_tpu_torch.traverse"""
