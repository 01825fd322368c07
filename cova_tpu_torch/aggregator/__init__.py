from cova_tpu_torch.aggregator.associator import Associator, BoxRec  # noqa: F401
