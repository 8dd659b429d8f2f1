"""Place recognition: the BoW vocabulary tree and the keyframe database."""
