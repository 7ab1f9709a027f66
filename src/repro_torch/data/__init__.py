"""Datasets (numpy only; copied from ``repro.data.tabular``)."""
from .tabular import DATASETS, TOPOLOGIES, load_dataset, TabularDataset
