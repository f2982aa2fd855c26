"""The upgrade state machine's vocabulary: states, label and annotation
keys (:mod:`.consts`) and the key builders, keyed mutex and event
recorders (:mod:`.util`)."""
