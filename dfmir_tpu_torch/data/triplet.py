"""``--dataset_mode triplet`` (the class lives beside its sibling in
``data/patient_site.py``, as in the JAX package)."""

from dfmir_tpu_torch.data.patient_site import TripletDataset

__all__ = ["TripletDataset"]
