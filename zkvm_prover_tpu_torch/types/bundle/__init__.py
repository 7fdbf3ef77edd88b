from .witness import BundleWitness, bundle_info_from_witness

__all__ = ["BundleWitness", "bundle_info_from_witness"]
