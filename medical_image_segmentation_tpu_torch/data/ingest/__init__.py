"""The data-curation layer (the JAX package's ``data/ingest/``): DICOM
scans and the curated 16-bit PNG subset, stores, statistics, Decathlon
slices, splits, segmentation stores, TCIA manifests. Images go through
OpenCV and PIL where they import and through ``utils/{png,jpeg,resize}.py``
elsewhere, to the same pixels."""
