from cavp_tpu_torch.data.synthetic import synthetic_eval_batch

__all__ = ["synthetic_eval_batch"]
