"""Raw media to features and answers: VGGish (``vggish``), the raw-media
forward (``e2e``) and the offline extraction stages (``extract``)."""
