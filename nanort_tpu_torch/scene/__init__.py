"""nanort_tpu_torch.scene"""
