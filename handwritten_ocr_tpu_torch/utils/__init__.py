"""Host-side helpers: JSON extraction and schema-guided decoding."""
