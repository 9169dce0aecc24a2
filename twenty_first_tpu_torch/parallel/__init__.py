"""The STARK LDE + commit pipeline."""
