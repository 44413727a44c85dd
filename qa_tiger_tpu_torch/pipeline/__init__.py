"""Raw media to features and answers: VGGish (``vggish``), the raw-media
forward (``e2e``), the offline extraction stages (``extract``) and the
packing of feature directories into memory-mapped shards
(``consolidate``)."""
